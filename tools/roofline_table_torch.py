"""§Roofline table of the port's dry-run: reads its artifacts -> markdown/CSV.
Counterpart of ``benchmarks/roofline_table.py``.

    PYTHONPATH=src python3 tools/roofline_table_torch.py [--mesh single_pod]
        [--csv] [--dir experiments/dryrun_torch]
    PYTHONPATH=src python3 tools/roofline_table_torch.py --mesh both

Emits, per (arch x shape) cell of ``python -m repro_torch.launch.dryrun``:
the three roofline terms on the ``H100`` spec (seconds, modelled), the
dominant term, MODEL_FLOPS / captured FLOPs, the tensor-core useful-lane
fraction, the per-rank peak bytes of ``core.aten.memory_analysis``,
whether it fits the card's HBM, and the one-line tuning hint of the PA
report; ``--mesh both`` puts both meshes' terms side by side, a row a
cell.  ``--capture`` lists each capture's host seconds, graph nodes, ops
and count-weighted totals instead, and ``--against DIR`` puts another
sweep's t_est and terms (with ``--mesh both``, its peaks and t_est)
beside these (an ``--unrolled`` sweep: the capture before loops were
counted; or an earlier tree's).  Host code: it reads JSON only.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

DRYRUN = Path("experiments/dryrun_torch")


def load_rows(mesh: str, root: Path = DRYRUN):
    rows = []
    d = Path(root) / mesh
    if not d.exists():
        return rows
    for p in sorted(d.glob("*.json")):
        r = json.loads(p.read_text())
        rows.append(r)
    return rows


def hint_of(r: dict) -> str:
    pa = r.get("pa_report", "")
    for line in pa.splitlines():
        line = line.strip()
        if line.startswith("- "):
            return line[2:].split(":")[0]
    return ""


def fmt_markdown(rows) -> str:
    out = ["| arch | shape | kind | compute s | memory s | collective s | "
           "dominant | MF/HLO | MXU lanes | peak GiB | fits | hint |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        rf = r["roofline"]
        mem = r.get("memory_analysis") or {}
        peak = (mem.get("peak_bytes_est") or 0) / 2**30
        fits = "Y" if r.get("fits_hbm") else "N"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {rf['compute_s']:.4f} | {rf['memory_s']:.4f} "
            f"| {rf['collective_s']:.4f} | **{rf['dominant']}** "
            f"| {rf['useful_flops_ratio']:.2f} | {rf['mxu_utilization']:.2f} "
            f"| {peak:.2f} | {fits} | {hint_of(r)} |")
    return "\n".join(out)


def fmt_csv(rows) -> str:
    out = ["arch,shape,kind,compute_s,memory_s,collective_s,dominant,"
           "mf_hlo,mxu_lanes,peak_gib"]
    for r in rows:
        rf = r["roofline"]
        mem = r.get("memory_analysis") or {}
        out.append(f"{r['arch']},{r['shape']},{r['kind']},"
                   f"{rf['compute_s']:.6f},{rf['memory_s']:.6f},"
                   f"{rf['collective_s']:.6f},{rf['dominant']},"
                   f"{rf['useful_flops_ratio']:.4f},"
                   f"{rf['mxu_utilization']:.4f},"
                   f"{(mem.get('peak_bytes_est') or 0) / 2**30:.3f}")
    return "\n".join(out)


def fmt_both(single, multi, against=None) -> str:
    """Both meshes side by side, a row a cell: the three terms (s), the
    dominant one and the peak GiB a rank on (16, 16), then on (2, 16,
    16); "—" where a mesh has no artifact for the cell.  With ``against``
    (another sweep's rows: an ``--unrolled`` one, or an earlier tree's)
    each mesh also shows that sweep's peak and t_est beside this one's."""
    old = {(r["arch"], r["shape"], r["mesh"]): r for r in against or ()}

    def peak(r):
        return ((r.get("memory_analysis") or {}).get("peak_bytes_est")
                or 0) / 2**30

    def terms(r):
        if r is None:
            return "— | — | —" + (" | —" if against is not None else "")
        rf = r["roofline"]
        out = (f"{rf['compute_s']:.4f} / {rf['memory_s']:.4f} / "
               f"{rf['collective_s']:.4f} | {rf['dominant']} | ")
        o = old.get((r["arch"], r["shape"], r["mesh"]))
        if against is not None:
            out += f"{peak(o):.2f} / " if o else "— / "
        out += f"{peak(r):.2f}{'' if r.get('fits_hbm') else ' (N)'}"
        if against is not None:
            out += (f" | {o['engine']['t_est']:.4f}" if o else " | —") + \
                f" / {r['engine']['t_est']:.4f}"
        return out
    by = {}
    for mesh, rows in (("single", single), ("multi", multi)):
        for r in rows:
            by.setdefault((r["arch"], r["shape"]), {})[mesh] = r
    t_est = " | t_est s old / new" if against is not None else ""
    vs = " old / new" if against is not None else ""
    out = ["| arch | shape | (16, 16) compute / memory / collective s "
           f"| dominant | peak GiB{vs}{t_est} | (2, 16, 16) compute / "
           f"memory / collective s | dominant | peak GiB{vs}{t_est} |",
           "|---|---|" + "---|" * (6 + 2 * bool(t_est))]
    for (arch, shape), r in sorted(by.items()):
        out.append(f"| {arch} | {shape} | {terms(r.get('single'))} "
                   f"| {terms(r.get('multi'))} |")
    return "\n".join(out)


def fmt_capture(rows) -> str:
    """Each cell's capture on the host: seconds, graph nodes, the
    Program's ops and their count-weighted instances, the count-weighted
    FLOPs, bytes and collective bytes a rank, and the process's peak
    resident memory."""
    out = ["| arch | shape | mesh | capture s | graph nodes | ops | op "
           "instances | TFLOP | TB | comm GB | peak RSS GiB |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        p = r["program"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_lower_s']:.2f} | {r['graph_nodes']} "
            f"| {r.get('ops', '—')} | {r.get('op_instances', 0):.0f} "
            f"| {p['flops_per_device'] / 1e12:.4f} "
            f"| {p['bytes_per_device'] / 1e12:.4f} "
            f"| {p['comm_bytes_per_device'] / 1e9:.3f} "
            f"| {r['peak_rss_bytes'] / 2**30:.2f} |")
    return "\n".join(out)


def fmt_compare(new, old) -> str:
    """Two sweeps of the same cells side by side (``old`` an ``--unrolled``
    one): t_est, the three terms and the dominant one; a cell without an
    artifact in either is left out."""
    by_old = {(r["arch"], r["shape"], r["mesh"]): r for r in old}
    out = ["| arch | shape | mesh | t_est s old / new | compute s old / new "
           "| memory s old / new | collective s old / new | dominant old / "
           "new |", "|---|---|---|---|---|---|---|---|"]
    for r in new:
        o = by_old.get((r["arch"], r["shape"], r["mesh"]))
        if o is None:
            continue
        a, b = o["roofline"], r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {o['engine']['t_est']:.4f} / {r['engine']['t_est']:.4f} "
            + "".join(f"| {a[k]:.4f} / {b[k]:.4f} " for k in
                      ("compute_s", "memory_s", "collective_s"))
            + f"| {a['dominant']} / {b['dominant']} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", default="single_pod",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--dir", type=Path, default=DRYRUN)
    ap.add_argument("--capture", action="store_true",
                    help="the captures' host numbers and counts instead")
    ap.add_argument("--against", type=Path, default=None,
                    help="another sweep's directory (an --unrolled one): "
                         "t_est and the terms side by side")
    args = ap.parse_args(argv)
    if args.mesh == "both" and args.against and not args.capture:
        single, multi = (load_rows(m, args.dir)
                         for m in ("single_pod", "multi_pod"))
        old = [r for m in ("single_pod", "multi_pod")
               for r in load_rows(m, args.against)]
        print(fmt_both(single, multi, old))
        return 0
    if args.capture or args.against:
        meshes = (("single_pod", "multi_pod") if args.mesh == "both"
                  else (args.mesh,))
        rows = [r for m in meshes for r in load_rows(m, args.dir)]
        if not rows:
            print(f"no artifacts under {args.dir}")
            return 1
        if args.against:
            old = [r for m in meshes for r in load_rows(m, args.against)]
            print(fmt_compare(rows, old))
        else:
            print(fmt_capture(rows))
        return 0
    if args.mesh == "both":
        single, multi = (load_rows(m, args.dir)
                         for m in ("single_pod", "multi_pod"))
        if not single and not multi:
            print(f"no artifacts under {args.dir}")
            return 1
        print(fmt_both(single, multi))
        return 0
    rows = load_rows(args.mesh, args.dir)
    if not rows:
        print(f"no artifacts under {args.dir / args.mesh}; "
              "run `python -m repro_torch.launch.dryrun` first")
        return 1
    print(fmt_csv(rows) if args.csv else fmt_markdown(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

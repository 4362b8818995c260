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
cell.  Host code: it reads JSON only.
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


def fmt_both(single, multi) -> str:
    """Both meshes side by side, a row a cell: the three terms (s), the
    dominant one and the peak GiB a rank on (16, 16), then on (2, 16,
    16); "—" where a mesh has no artifact for the cell."""
    def terms(r):
        if r is None:
            return "— | — | —"
        rf = r["roofline"]
        peak = (r.get("memory_analysis") or {}).get("peak_bytes_est") or 0
        return (f"{rf['compute_s']:.4f} / {rf['memory_s']:.4f} / "
                f"{rf['collective_s']:.4f} | {rf['dominant']} "
                f"| {peak / 2**30:.2f}{'' if r.get('fits_hbm') else ' (N)'}")
    by = {}
    for mesh, rows in (("single", single), ("multi", multi)):
        for r in rows:
            by.setdefault((r["arch"], r["shape"]), {})[mesh] = r
    out = ["| arch | shape | (16, 16) compute / memory / collective s "
           "| dominant | peak GiB | (2, 16, 16) compute / memory / "
           "collective s | dominant | peak GiB |",
           "|---|---|---|---|---|---|---|---|"]
    for (arch, shape), r in sorted(by.items()):
        out.append(f"| {arch} | {shape} | {terms(r.get('single'))} "
                   f"| {terms(r.get('multi'))} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", default="single_pod",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--dir", type=Path, default=DRYRUN)
    args = ap.parse_args(argv)
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

"""Model-zoo sweep on the port: every registry config through the node engine,
the O3 grid's sweeps on the scan kernel.

    PYTHONPATH=src python3 tools/model_zoo_torch.py [--quick] [--device cpu]

The port's counterpart of ``benchmarks/model_zoo.py`` (DESIGN.md §15):
``core.zoo.run_zoo`` captures each architecture's train/prefill/decode
phases at reduced width as ATen graphs (fake tensors, nothing runs),
shards them over the A64FX node topology and reports contention-aware
cycle estimates at 1/12/48 cores, the 12-combo O3 grid of each cell as
one fused sweep through the scan kernel on ``--device`` (``cpu`` runs its
plain version), and the rank-stability Kendall taus.

It also prints, per phase and core count, the Kendall tau of its ranks
against the reference's committed ranks (``--ref``, default
``BENCH_model_zoo.json``).  Writes ``--out`` (default
``BENCH_model_zoo_torch.json``; DESIGN.md §16's ``BENCH_model_zoo.json``
schema, plus ``card``, ``device`` and ``vs_reference``).  Parsed programs
are cached under ``experiments/zoo_programs/``; ``--budget`` fails the run
when the sweep takes longer (0 disables).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core.hwspec import A64FX_CORE  # noqa: E402
from repro_torch.core.zoo import (DEFAULT_CORE_COUNTS,  # noqa: E402
                                  kendall_tau, run_zoo)
from sched_throughput_torch import card  # noqa: E402

BENCH_JSON = Path("BENCH_model_zoo_torch.json")
REFERENCE_JSON = Path("BENCH_model_zoo.json")
PROGRAM_CACHE = Path("experiments/zoo_programs")
# the reference's --quick cut: one model per family class that matters to
# the rank tables (dense, GQA dense, MoE, SSM, enc-dec)
QUICK_MODELS = ("chatglm3-6b", "qwen1.5-32b", "llama4-scout-17b-a16e",
                "mamba2-1.3b", "whisper-large-v3")


def taus_against(ref: dict, got: dict) -> dict:
    """``{phase: {cores: tau}}``: the Kendall tau of ``got``'s rank table
    against ``ref``'s over the archs both rank, for every phase and core
    count of ``got`` that ``ref`` has (two BENCH_model_zoo payloads)."""
    out = {}
    for ph in got["phases"]:
        for k in map(str, got["core_counts"]):
            mine = got["rank"][ph][k]
            theirs = ref.get("rank", {}).get(ph, {}).get(k)
            if theirs is None:
                continue
            common = [a for a in mine if a in theirs]
            out.setdefault(ph, {})[k] = kendall_tau(
                [theirs.index(a) for a in common],
                [mine.index(a) for a in common])
    return out


def _progress(arch: str, phase: str, pe, wall: float) -> None:
    by_core = "  ".join(
        f"{ce.n_cores}c {ce.t_est_s * 1e6:9.1f}us" for ce in pe.per_core)
    print(f"  {arch:<24s}{phase:<9s}{pe.n_ops:>5d} ops  {by_core}  "
          f"x{pe.node_speedup:5.1f}  {pe.roofline_dominant:<7s}"
          f"[{wall:5.2f}s]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help=f"only {len(QUICK_MODELS)} representative models")
    ap.add_argument("--arch", action="append", default=None,
                    help="sweep only this architecture (repeatable)")
    ap.add_argument("--phases", default=None,
                    help="comma-separated subset of train,prefill,decode")
    ap.add_argument("--core-counts", default=None,
                    help=f"comma-separated (default {DEFAULT_CORE_COUNTS})")
    ap.add_argument("--budget", type=float, default=900.0,
                    help="wall-clock budget in seconds (0 disables)")
    ap.add_argument("--no-o3-grid", action="store_true")
    ap.add_argument("--no-cache", action="store_true",
                    help=f"always capture (ignore {PROGRAM_CACHE}/)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--ref", type=Path, default=REFERENCE_JSON)
    ap.add_argument("--out", type=Path, default=BENCH_JSON)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.device import resolve
    device = resolve(args.device)
    models = args.arch or (list(QUICK_MODELS) if args.quick
                           else sorted(ARCHS))
    for m in models:
        if m not in ARCHS:
            ap.error(f"unknown arch {m!r}; known: {sorted(ARCHS)}")
    phases = args.phases.split(",") if args.phases else None
    core_counts = (tuple(int(c) for c in args.core_counts.split(","))
                   if args.core_counts else DEFAULT_CORE_COUNTS)

    print(f"== model zoo -> node engine ({A64FX_CORE.name}, {len(models)} "
          f"models, cores {core_counts}, O3 grid on the scan on {device}) ==")
    report = run_zoo(models=models, phases=phases, hw=A64FX_CORE,
                     core_counts=core_counts,
                     with_o3_grid=not args.no_o3_grid,
                     hlo_cache_dir=None if args.no_cache else PROGRAM_CACHE,
                     progress=_progress, backend="torch",
                     device=device)
    d = report.to_dict()
    ref = json.loads(args.ref.read_text()) if args.ref.exists() else {}
    d["vs_reference"] = taus_against(ref, d)
    print("== rank tables (fastest first), stability and agreement with "
          f"{args.ref} ==")
    for ph in report.phases:
        taus = d["kendall_tau"][ph]
        vs = d["vs_reference"].get(ph, {})
        print(f"  {ph:<9s}tau(min over core axis)={taus['min']:+.3f}  "
              f"tau(vs traced flops)={taus['vs_flops']:+.3f}  tau(vs "
              f"reference) " + "  ".join(f"@{k}c {t:+.3f}"
                                         for k, t in vs.items()))
        print(f"           @{min(core_counts)}c: "
              + " > ".join(d["rank"][ph][str(min(core_counts))]))
    d["card"] = card() if device.type == "cuda" else "cpu"
    d["device"] = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    args.out.write_text(json.dumps(d, indent=1, sort_keys=True))
    print(f"wrote {args.out} ({len(models)} models x {len(report.phases)} "
          f"phases x {len(core_counts)} core counts) in {report.wall_s:.1f}s")
    if args.budget and report.wall_s > args.budget:
        print(f"BUDGET EXCEEDED: {report.wall_s:.1f}s > {args.budget:.0f}s",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sampled estimation on the port: sampled vs full node scheduling.

    PYTHONPATH=src python3 tools/sampled_estimation_torch.py [--quick] [--device cpu]

The port's counterpart of ``benchmarks/sampled_estimation.py``: the
SimPoint-style sampler (``core.sample``, DESIGN.md §18) on three program
families, with the reference's floors:

* **bench DAG** — the repetitive 10k-op synthetic trace (the 250-op step
  of ``tools/sched_throughput_torch.synthetic_program``, seed 3, unrolled
  40x), monolithic full schedule vs sampled reconstruction at 48 cores.
  Floors: sampled wall-clock speedup >= 3x while scheduling <= 20 % of op
  instances within 5 % reconstruction error.
* **zoo long traces** — full-depth/multi-step zoo cells
  (``zoo.trace_long_phase``: the captured reduced step unrolled by the
  full/reduced layer ratio, 1024 decode steps) through the whole
  ``estimate_program`` pipeline (3 core counts x the 12-combo O3 grid, its
  sweeps through the scan kernel on ``--device``), once unsampled and once
  sampled; within 5 %
  at 12 cores, the sampled pass under ``--budget``.  ``--quick``: one
  model.
* **kernel suite** (full mode) — every Table-1 kernel's program
  (``calibrate.kernel_program``) unrolled 32x, the same error/fraction
  floors.

Writes ``--out`` (default ``BENCH_sampling_torch.json``; the reference's
``BENCH_sampling.json`` schema, DESIGN.md §18, plus ``card`` and
``device``).  Exits 1 when a floor fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.configs import ARCHS, ZOO_SHAPES, zoo_phases_for  # noqa: E402
from repro_torch.configs.a64fx_kernelsuite import KERNELS  # noqa: E402
from repro_torch.core.calibrate import SIZE_SCALE, kernel_program  # noqa: E402
from repro_torch.core.hwspec import A64FX_CORE  # noqa: E402
from repro_torch.core.sample import (SamplingConfig,  # noqa: E402
                                     measure_sampled_vs_full,
                                     unroll_program)
from repro_torch.core.zoo import (estimate_program,  # noqa: E402
                                  phase_model_flops, trace_long_phase,
                                  zoo_config, zoo_o3_knobs)
from sched_throughput_torch import card, synthetic_program  # noqa: E402

BENCH_JSON = Path("BENCH_sampling_torch.json")
PROGRAM_CACHE = Path("experiments/zoo_programs")

SPEEDUP_FLOOR = 3.0          # sampled >= 3x full on the 10k-op bench DAG
FRAC_CEIL = 0.20             # while scheduling <= 20% of op instances
ERR_CEIL_PCT = 5.0           # within 5% reconstruction error
BENCH_CORES = 48
ZOO_CORES = (1, 12, 48)
DECODE_STEPS = 1024
KERNEL_REPEATS = 32
QUICK_MODELS = ("chatglm3-6b",)


def bench_dag_row() -> dict:
    """Monolithic vs sampled on the repetitive 10k-op bench DAG."""
    step = synthetic_program(250, seed=3)
    step_inst = sum(o.count for o in step.ops)
    prog = unroll_program(step, 40)
    cfg = SamplingConfig(interval_ops=step_inst, phase_aware=False)
    row = measure_sampled_vs_full(prog, A64FX_CORE, BENCH_CORES,
                                  config=cfg, compute_dtype="f64")
    row["n_cores"] = BENCH_CORES
    return row


def zoo_phase_row(arch: str, phase: str, budget_s: float, device) -> dict:
    """One full-depth zoo cell through ``estimate_program``, unsampled vs
    sampled, the O3 grid's sweeps through the scan on ``device``."""
    prog, repeats = trace_long_phase(arch, phase, hlo_cache_dir=PROGRAM_CACHE,
                                     decode_steps=DECODE_STEPS)
    flops = phase_model_flops(zoo_config(arch), ZOO_SHAPES[phase])
    knobs = zoo_o3_knobs(A64FX_CORE)
    step_inst = sum(o.count for o in prog.ops) / repeats
    kw = dict(model_flops=flops, o3_knobs=knobs, arch=arch, phase=phase,
              backend="torch", device=device)

    t0 = time.perf_counter()
    pe_full = estimate_program(prog, A64FX_CORE, ZOO_CORES, **kw)
    wall_full = time.perf_counter() - t0

    t0 = time.perf_counter()
    pe_sam = estimate_program(
        prog, A64FX_CORE, ZOO_CORES,
        sampling=SamplingConfig(interval_ops=step_inst, phase_aware=False),
        **kw)
    wall_sampled = time.perf_counter() - t0

    t_full = pe_full.at(12).t_est_s
    t_sam = pe_sam.at(12).t_est_s
    return {
        "n_ops": pe_full.n_ops,
        "trace_repeats": repeats,
        "k": pe_sam.sampling["k"],
        "n_intervals": pe_sam.sampling["n_intervals"],
        "frac_ops_scheduled": pe_sam.sampling["frac_ops_scheduled"],
        "t_full_us": t_full * 1e6,
        "t_sampled_us": t_sam * 1e6,
        "reconstruction_error_pct":
            100.0 * (t_sam - t_full) / max(t_full, 1e-30),
        "t_best_knobs_full_us": pe_full.at(12).t_best_knobs_s * 1e6,
        "t_best_knobs_sampled_us": pe_sam.at(12).t_best_knobs_s * 1e6,
        "wall_full_s": wall_full,
        "wall_sampled_s": wall_sampled,
        "speedup": wall_full / max(wall_sampled, 1e-30),
        "budget_s": budget_s,
        "full_exceeds_budget": wall_full > budget_s,
        "sampled_under_budget": wall_sampled <= budget_s,
    }


def kernel_rows() -> dict:
    """Every Table-1 kernel's program at Table 1's n x SIZE_SCALE, unrolled
    KERNEL_REPEATS times, at 12 cores."""
    out = {}
    for k in KERNELS:
        prog = kernel_program(k.name, k.n * SIZE_SCALE)
        step_inst = sum(o.count for o in prog.ops)
        row = measure_sampled_vs_full(
            unroll_program(prog, KERNEL_REPEATS), A64FX_CORE, 12,
            config=SamplingConfig(interval_ops=step_inst, phase_aware=False),
            compute_dtype="f64")
        row["repeats"] = KERNEL_REPEATS
        out[k.name] = row
    return out


def check(dag: dict, zoo: dict, kernels: dict, speedup_floor: float,
          budget: float) -> list:
    """The floors' failures, as messages (none: every floor holds)."""
    bad = []
    if dag["speedup"] < speedup_floor:
        bad.append(f"bench DAG sampled speedup {dag['speedup']:.2f}x is "
                   f"below the {speedup_floor:.1f}x floor")
    rows = [("bench DAG", dag)] + [
        (f"{a}/{p}", r) for a, by in zoo.items() for p, r in by.items()] + [
        (f"kernel {n}", r) for n, r in kernels.items()]
    for cell, row in rows:
        if abs(row["reconstruction_error_pct"]) > ERR_CEIL_PCT:
            bad.append(f"{cell} error {row['reconstruction_error_pct']:+.2f}"
                       f"% exceeds {ERR_CEIL_PCT:.0f}%")
        if row["frac_ops_scheduled"] > FRAC_CEIL:
            bad.append(f"{cell} scheduled "
                       f"{100 * row['frac_ops_scheduled']:.1f}% of instances "
                       f"(> {100 * FRAC_CEIL:.0f}%)")
        if budget and not row.get("sampled_under_budget", True):
            bad.append(f"{cell} sampled estimate took "
                       f"{row['wall_sampled_s']:.1f}s (> {budget:.0f}s)")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help=f"bench DAG + {len(QUICK_MODELS)} zoo model(s), no "
                         "kernel suite")
    ap.add_argument("--speedup-floor", type=float, default=SPEEDUP_FLOOR)
    ap.add_argument("--budget", type=float, default=10.0,
                    help="per-cell wall budget (s) of a sampled full-depth "
                         "estimate (0 disables)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--out", type=Path, default=BENCH_JSON)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.device import resolve
    device = resolve(args.device)

    t_start = time.perf_counter()
    print(f"== sampled estimation ({A64FX_CORE.name}, sweeps on the scan "
          f"on {device}) ==")
    dag = bench_dag_row()
    print(f"  bench DAG   {dag['n_ops']:>6d} ops  k={dag['k']}/"
          f"{dag['n_intervals']}  frac={dag['frac_ops_scheduled']:.3f}  "
          f"err={dag['reconstruction_error_pct']:+.3f}%  "
          f"speedup={dag['speedup']:.1f}x")
    models = QUICK_MODELS if args.quick else sorted(ARCHS)
    zoo: dict = {}
    for arch in models:
        zoo[arch] = {}
        for phase in zoo_phases_for(zoo_config(arch)):
            row = zoo_phase_row(arch, phase, args.budget, device)
            zoo[arch][phase] = row
            print(f"  {arch:<24s}{phase:<9s}{row['n_ops']:>7d} ops "
                  f"x{row['trace_repeats']:<4d} k={row['k']}/"
                  f"{row['n_intervals']:<4d} "
                  f"frac={row['frac_ops_scheduled']:.4f}  "
                  f"err={row['reconstruction_error_pct']:+.3e}%  "
                  f"full={row['wall_full_s']:6.2f}s  "
                  f"sampled={row['wall_sampled_s']:5.2f}s", flush=True)
    kernels = {} if args.quick else kernel_rows()
    for name, row in kernels.items():
        print(f"  kernel:{name:<17s}{row['n_ops']:>6d} ops  "
              f"frac={row['frac_ops_scheduled']:.3f}  "
              f"err={row['reconstruction_error_pct']:+.3f}%")
    out = {
        "schema": 1,
        "hw": A64FX_CORE.name,
        "quick": bool(args.quick),
        "card": card() if device.type == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "floors": {"speedup": args.speedup_floor, "frac": FRAC_CEIL,
                   "error_pct": ERR_CEIL_PCT, "budget_s": args.budget},
        "bench_dag": dag,
        "zoo": zoo,
        "kernels": kernels,
        "wall_s": time.perf_counter() - t_start,
    }
    args.out.write_text(json.dumps(out, indent=1, sort_keys=True))
    print(f"wrote {args.out} in {out['wall_s']:.1f}s")
    bad = check(dag, zoo, kernels, args.speedup_floor, args.budget)
    for msg in bad:
        print(f"FAIL: {msg}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

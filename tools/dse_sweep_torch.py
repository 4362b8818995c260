"""Hardware DSE sweep on the port: the 64-candidate grid over the zoo, the
fused sweep's passes on the scan kernel.

    PYTHONPATH=src python3 tools/dse_sweep_torch.py [--quick] [--backend numpy] [--device cpu]

The port's counterpart of ``benchmarks/dse_sweep.py`` (DESIGN.md §19).
``core.dse`` drives the 64-point candidate grid (CMG count x cores/CMG x
HBM stacks x ring latency x VPU width) through zoo workloads as ONE
batched costing + contention fixpoint per program, the fixpoint's passes
on ``--backend`` (``torch``, the default: the scan kernel on ``--device``,
``kernels.sched_scan``; ``cpu`` runs its plain version; ``numpy``: the
host), and times that path against the per-spec loop (``compile_node`` +
``schedule_node_batch`` once per candidate, NumPy), both cold.  The two
must be bit-identical, and the run FAILS when the fused path drops below
``--floor`` times the loop.

Full mode sweeps ``FULL_MODELS`` x (prefill, decode) through the port's
ATen captures (parsed programs cached under ``experiments/zoo_programs/``)
and writes ``--out`` (default ``BENCH_dse_torch.json``; the
``BENCH_dse.json`` schema plus ``throughput``, ``card``, ``device`` and
``vs_reference``: per workload the Kendall tau of the candidates' ranks
against the reference's committed ``BENCH_dse.json`` and whether
``best_spec`` agrees; reported, not gated — the captures are unrolled, so
the two agree in rank, not in bits).  ``--quick`` runs the synthetic
2,000-op DAG (``sched_throughput_torch.synthetic_program``) and writes
``BENCH_dse_torch_quick.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.core.compiled import O3Knobs  # noqa: E402
from repro_torch.core.dse import (generate_grid, run_dse,  # noqa: E402
                                  spec_grid, sweep_workload)
from repro_torch.core.node import (compile_node,  # noqa: E402
                                   compile_node_grid, schedule_node_batch,
                                   schedule_spec_sweep)
from repro_torch.core.zoo import kendall_tau  # noqa: E402
from sched_throughput_torch import card, synthetic_program  # noqa: E402

BENCH_JSON = Path("BENCH_dse_torch.json")
QUICK_JSON = Path("BENCH_dse_torch_quick.json")
REFERENCE_JSON = Path(__file__).resolve().parents[1] / "BENCH_dse.json"
PROGRAM_CACHE = Path("experiments/zoo_programs")
SPEEDUP_FLOOR = 10.0
# the reference bench's full cut: prefill + decode of five models, one per
# family class
FULL_MODELS = ("chatglm3-6b", "qwen1.5-32b", "llama4-scout-17b-a16e",
               "mamba2-1.3b", "whisper-large-v3")
FULL_PHASES = ("prefill", "decode")
QUICK_N_OPS = 2_000


def _clear_caches(prog) -> None:
    """Drop the per-Program compile memos so every timed round pays the
    same cold-cache cost."""
    for k in ("_node_cache", "_node_grid_cache", "_compiled_cache"):
        prog.__dict__.pop(k, None)


def measure_throughput(prog, grid, compute_dtype="f32",
                       loop_rounds: int = 1, fused_rounds: int = 3,
                       backend: str = "torch", device="cuda") -> dict:
    """Time the fused spec sweep (its passes on ``backend``) against the
    per-spec loop on ``prog``.

    Both paths run cold (caches cleared per round) and compute the same
    [S] vector: each candidate scheduled shard-partitioned at its full
    core count with its own default O3 knobs.  Raises unless the two are
    bit-identical.  Returns wall times, per-spec throughputs and the
    speedup."""
    S = grid.S

    def fused():
        _clear_caches(prog)
        ngc = compile_node_grid(prog, grid, compute_dtype=compute_dtype)
        return schedule_spec_sweep(ngc, backend=backend,
                                   device=device)[:, 0, 0]

    def loop():
        _clear_caches(prog)
        out = np.empty(S)
        for s, sp in enumerate(grid.specs):
            topo = grid.topology_of(s)
            nc = compile_node(prog, sp, compute_dtype=compute_dtype)
            res = schedule_node_batch(nc, sp, O3Knobs.single(sp),
                                      topo.n_cores, topology=topo,
                                      partition="shard")
            out[s] = res.t_est[0]
        return out

    t_fused = fused()          # warm numpy / allocator / the kernel once
    t0 = time.perf_counter()
    for _ in range(fused_rounds):
        t_fused = fused()
    wall_fused = (time.perf_counter() - t0) / fused_rounds
    t0 = time.perf_counter()
    for _ in range(loop_rounds):
        t_loop = loop()
    wall_loop = (time.perf_counter() - t0) / loop_rounds

    if not np.array_equal(t_fused, t_loop):
        raise AssertionError(
            "fused sweep diverged from the per-spec loop "
            f"(max delta {np.abs(t_fused - t_loop).max():.3e})")
    return {
        "n_ops": len(prog.ops), "n_specs": S,
        "fused_wall_s": wall_fused, "loop_wall_s": wall_loop,
        "fused_specs_per_s": S / wall_fused,
        "loop_specs_per_s": S / wall_loop,
        "speedup": wall_loop / wall_fused,
        "bit_identical": True,
        "backend": backend,
    }


def against_reference(ref: dict, got: dict) -> dict:
    """Per workload both payloads hold: the Kendall tau of the candidates'
    estimates (the same 64 points in the same order) and whether the best
    candidate agrees."""
    out = {}
    for key, row in got["per_workload"].items():
        theirs = ref.get("per_workload", {}).get(key)
        if theirs is None:
            continue
        out[key] = {
            "kendall_tau": kendall_tau(theirs["t_est_s"], row["t_est_s"]),
            "best_spec": row["best_spec"],
            "reference_best_spec": theirs["best_spec"],
            "best_spec_agrees": row["best_spec"] == theirs["best_spec"],
            "n_ops": row["n_ops"], "reference_n_ops": theirs["n_ops"],
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="synthetic-DAG smoke (no capture); writes "
                         f"{QUICK_JSON}")
    ap.add_argument("--floor", type=float, default=SPEEDUP_FLOOR,
                    help="fail when fused/loop speedup drops below this")
    ap.add_argument("--backend", default="torch", choices=("torch", "numpy"),
                    help="the fused sweep's passes: the scan kernel on "
                         "--device, or NumPy on the host")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--no-cache", action="store_true",
                    help=f"always capture (ignore {PROGRAM_CACHE}/)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.device import resolve
    device = resolve(args.device)
    on_card = device.type == "cuda"

    points = generate_grid()
    grid = spec_grid(points)
    kw = dict(backend=args.backend, device=device)

    if args.quick:
        print(f"== DSE sweep: {grid.S} candidate specs (synthetic smoke, "
              f"{args.backend} on {device}) ==")
        prog = synthetic_program(QUICK_N_OPS)
        thr = measure_throughput(prog, grid, **kw)
        sw = sweep_workload(prog, grid, **kw)
        out = {
            "schema": 1, "mode": "quick",
            "n_specs": grid.S, "n_ops": thr["n_ops"],
            "throughput": thr, "floor_speedup": args.floor,
            "t_est_min_s": float(sw["t_est"].min()),
            "t_est_max_s": float(sw["t_est"].max()),
        }
        target = args.out or QUICK_JSON
    else:
        from repro_torch.core.zoo import trace_phase, zoo_workloads
        workloads = zoo_workloads(FULL_MODELS, FULL_PHASES)
        print(f"== DSE sweep: {grid.S} candidate specs ({len(workloads)} zoo "
              f"workloads, {args.backend} on {device}) ==")
        cache = None if args.no_cache else PROGRAM_CACHE
        t0 = time.perf_counter()
        out = run_dse(workloads, points=points, hlo_cache_dir=cache,
                      progress=lambda m: print(f"  {m}", flush=True), **kw)
        out["wall_s"] = time.perf_counter() - t0
        # time the fused-vs-loop race on the biggest captured workload
        key = max(out["per_workload"],
                  key=lambda k: out["per_workload"][k]["n_ops"])
        arch, phase = key.split("/")
        prog = trace_phase(arch, phase, hlo_cache_dir=cache)
        thr = measure_throughput(prog, grid, **kw)
        out["throughput"] = {**thr, "workload": key,
                             "floor_speedup": args.floor}
        rs = out["rank_stability"]
        print(f"  rank stability: mean tau {rs['mean_tau']:+.3f}, "
              f"min {rs['min_tau']:+.3f} across "
              f"{len(out['workloads'])} workloads")
        out["vs_reference"] = against_reference(
            json.loads(REFERENCE_JSON.read_text()), out)
        for k, v in out["vs_reference"].items():
            print(f"  {k:<32s} tau vs {REFERENCE_JSON.name} "
                  f"{v['kendall_tau']:+.3f}  "
                  f"best {v['best_spec']} (reference "
                  f"{v['reference_best_spec']})")
        target = args.out or BENCH_JSON
    out["card"] = card() if on_card else "cpu"
    out["device"] = torch.cuda.get_device_name(device) if on_card else "cpu"
    target.write_text(json.dumps(out, indent=1))

    print(f"fused:  {thr['fused_wall_s'] * 1e3:8.1f} ms/sweep "
          f"({thr['fused_specs_per_s']:,.0f} specs/s)")
    print(f"loop:   {thr['loop_wall_s'] * 1e3:8.1f} ms/sweep "
          f"({thr['loop_specs_per_s']:,.0f} specs/s)")
    print(f"speedup: {thr['speedup']:.1f}x (bit-identical), "
          f"floor {args.floor:.0f}x")
    print(f"wrote {target}")
    if thr["speedup"] < args.floor:
        print(f"FAIL: fused sweep speedup {thr['speedup']:.1f}x is below "
              f"the floor of {args.floor:.0f}x")
        return 1
    print("OK: fused sweep above the floor")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The schedulers' throughput on a synthetic 10k-op DAG, NumPy beside the
scan kernel on the card.

    PYTHONPATH=src python3 tools/sched_throughput_torch.py [--device cuda]

The port's counterpart of ``benchmarks/sched_throughput.py``: the same
DAG (10,000 ops, seed 0), the same O3 grid (``calibrate.sweep_o3``'s 90
combos) and the same accounting (one scheduled op-instance is one op
advanced through one in-order pass: ``n_ops x combos`` a batched call,
``n_ops x fixpoint passes`` for the node engines).  Each batched case runs
once with ``backend="numpy"`` (the reference's default path, on the host)
and once with ``backend="torch"`` (the scan kernel, ``kernels.sched_scan``,
on ``--device``; ``cpu`` runs its plain version), after an uncounted
warm-up of each, and the two results must be bit-identical:

* ``schedule_batch``: ``core.compiled`` under ``CPU_HOST`` (the bench's
  batched kernel);
* ``node_round_robin``, ``node_graph``: ``schedule_node_batch`` at 48
  cores of ``A64FX_NODE`` under ``A64FX_CORE`` (48 streams, the ring
  addend on cross-CMG edges);
* ``node_sweep_shard``: ``schedule_node_sweep`` at core counts (12, 48),
  shard (one stream, 180 elements).

Prints one JSON line: the card's name and power limit (``nvidia-smi``),
and per case the wall seconds of both backends, op-instances per second,
fixpoint passes, and the kernel's launches and device time (CUDA events
around each launch).  It writes no file.
"""
from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.compiled import (O3Knobs, compile_program,  # noqa: E402
                                       schedule_batch)
from repro_torch.core.hlo import OpStat, Program  # noqa: E402
from repro_torch.core.hwspec import A64FX_CORE, A64FX_NODE, CPU_HOST  # noqa: E402
from repro_torch.core.node import (compile_node, schedule_node_batch,  # noqa: E402
                                   schedule_node_sweep)
from repro_torch.kernels import sched_scan  # noqa: E402

N_OPS = 10_000
NODE_CORES = 48
SWEEP_CORES = (12, 48)
# calibrate.sweep_o3's default grid (O3_WINDOWS x O3_MEM_WIDTHS x
# O3_VPU_WIDTHS x O3_QUEUE_DEPTHS), 90 combos
GRID_COMBOS = [(w, mw, vw, qd)
               for w in (4, 16, 64, 256, 1024)
               for mw in (1, 2, 4) for vw in (1, 2) for qd in (4, 16, 64)]


def synthetic_program(n: int = N_OPS, seed: int = 0) -> Program:
    """``benchmarks/sched_throughput.py``'s DAG, op for op: mostly
    short-range def-use edges, a mix of ports, some collapsed-loop
    counts."""
    rng = random.Random(seed)
    ops = []
    for i in range(n):
        k = min(i, rng.randint(0, 3))
        lo = max(0, i - 64)
        deps = sorted(rng.sample(range(lo, i), min(k, i - lo)))
        cls = rng.choice(["elementwise", "elementwise", "data", "matmul",
                          "reduce", "transcendental"])
        ops.append(OpStat(
            f"op{i}", "fusion", cls, "f32",
            flops=rng.uniform(1e3, 1e9),
            transcendentals=rng.uniform(0, 1e3),
            bytes_accessed=rng.uniform(1e3, 1e8),
            read_bytes=rng.uniform(1e3, 5e7),
            write_bytes=rng.uniform(0, 5e7),
            count=rng.choice([1.0, 1.0, 1.0, 4.0]),
            deps=deps, dep_bytes=[rng.uniform(0, 1e6) for _ in deps]))
    return Program(ops=ops, entry="synthetic", n_partitions=1)


def card() -> str:
    """``nvidia-smi``'s name and power limit, or ``"not measured"``."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "not measured"


def compare(label: str, run, n_ops: int, device) -> dict:
    """Run ``run(backend, device)`` (it returns ``t_est``) with NumPy and
    with the scan on ``device``, each after an uncounted warm-up; fail
    unless the two are bit-identical.  The torch run counts the kernel's
    launches, the batch elements they scheduled and their device time."""
    import torch
    on_card = torch.device(device).type == "cuda"
    out = {"case": label, "n_ops": n_ops}
    for backend in ("numpy", "torch"):
        run(backend, device)
        sched_scan.node_scan.launches = 0
        sched_scan.node_scan.elements = 0
        sched_scan.node_scan.events = [] if on_card else None
        t0 = time.perf_counter()
        t = run(backend, device)
        if on_card:
            torch.cuda.synchronize()
        out[f"{backend}_s"] = time.perf_counter() - t0
        if backend == "numpy":
            want = t
            continue
        events = sched_scan.node_scan.events
        sched_scan.node_scan.events = None
        differ = int(np.count_nonzero(t.view(np.int64) != want.view(np.int64)))
        if t.shape != want.shape or differ:
            raise SystemExit(f"{label}: backend='torch' differs from "
                             f"'numpy' in {differ} of {want.size} elements")
        elements = sched_scan.node_scan.elements
        out.update(
            elements=int(want.size), differing=differ,
            launches=sched_scan.node_scan.launches,
            passes_elements=elements, scheduled_ops=n_ops * elements,
            kernel_ms=(sum(a.elapsed_time(b) for _, a, b in events)
                       if on_card else None),
            first_launch=({"elements": events[0][0],
                           "ms": events[0][1].elapsed_time(events[0][2])}
                          if on_card and events else None))
    for backend in ("numpy", "torch"):
        out[f"{backend}_ops_per_s"] = out["scheduled_ops"] / out[
            f"{backend}_s"]
    out["speedup"] = out["numpy_s"] / out["torch_s"]
    return out


def cases(prog: Program):
    """(label, run(backend, device) -> t_est) of the four cases on
    ``prog``."""
    cp = compile_program(prog, CPU_HOST, compute_dtype="f64")
    grid = O3Knobs.from_grid(CPU_HOST, GRID_COMBOS)
    nc = compile_node(prog, A64FX_CORE, compute_dtype="f64")
    ngrid = O3Knobs.from_grid(A64FX_CORE, GRID_COMBOS)
    yield "schedule_batch", lambda b, d: schedule_batch(cp, grid, b, d)
    for part in ("round-robin", "graph"):
        yield (f"node_{part.replace('-', '_')}",
               lambda b, d, part=part: schedule_node_batch(
                   nc, A64FX_CORE, ngrid, NODE_CORES, A64FX_NODE, part,
                   backend=b, device=d).t_est)
    yield ("node_sweep_shard",
           lambda b, d: schedule_node_sweep(
               nc, A64FX_CORE, ngrid, SWEEP_CORES, A64FX_NODE, "shard",
               backend=b, device=d).ravel())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel; raises without a card) or cpu "
                         "(its plain version)")
    ap.add_argument("--ops", type=int, default=N_OPS)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.device import resolve
    device = resolve(args.device)
    prog = synthetic_program(args.ops)
    rows = [compare(label, run, len(prog.ops), device)
            for label, run in cases(prog)]
    print(json.dumps({
        "card": card(),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "program": {"n_ops": len(prog.ops), "seed": 0},
        "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

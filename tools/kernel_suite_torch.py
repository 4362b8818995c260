"""Paper Table 1 + Fig. 3 on the port: the 28-kernel suite, simulator vs
measured, with the H100 (or the CPU) as the test chip.

    PYTHONPATH=src python3 tools/kernel_suite_torch.py [--quick] [--device cpu]

The port's counterpart of ``benchmarks/kernel_suite.py``.  It fits the
parameter file on the test chip (``calibrate.fit_h100`` on the card, each
microbenchmark a K1 launch; ``calibrate.fit_cpu_host`` under ``--device
cpu``, the plain K1 functions), times every Table-1 kernel through K1
(``kernel_accuracy_table``) and holds it against ``simulate`` of the same
launch's program, then reports:

* the Fig. 3 accuracy table (occupancy and schedule engines) against the
  paper's +1.3 / 7.8 / 6.6 / 82 %;
* ``scheduler_throughput``: the O3 scheduler's op-instances a second over
  the suite's programs (NumPy, on the host);
* the simulated A64FX single-core cycles per 8-element operation (Fig. 3's
  bars) and the contention-aware A64FX node estimates at 1/12/48 cores.

Writes ``--out`` (default ``BENCH_kernel_suite_h100.json``; DESIGN.md
§16's ``BENCH_kernel_suite.json`` schema, plus ``card`` and ``device``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.configs.a64fx_kernelsuite import (  # noqa: E402
    KERNELS, PAPER_MEAN_ABS_DIFF_PCT, PAPER_MEAN_DIFF_PCT,
    PAPER_STD_DIFF_PCT, PAPER_WITHIN_10PCT_FRACTION)
from repro_torch.core import calibrate  # noqa: E402
from repro_torch.core.compiled import (compile_program,  # noqa: E402
                                       schedule_arrays, schedule_batch)
from repro_torch.core.cost import cost_program  # noqa: E402
from repro_torch.core.hwspec import A64FX_CORE, HardwareSpec  # noqa: E402
from repro_torch.core.node import compile_node, schedule_node  # noqa: E402
from repro_torch.core.schedule import schedule_reference  # noqa: E402
from repro_torch.core.simulate import simulate  # noqa: E402
from sched_throughput_torch import card  # noqa: E402

BENCH_JSON = Path("BENCH_kernel_suite_h100.json")
# node estimates: 1 core / one full CMG / the whole 4-CMG node
NODE_CORE_COUNTS = (1, 12, 48)


def scheduler_throughput(table: calibrate.AccuracyTable,
                         hw: HardwareSpec, min_wall_s: float = 0.2) -> dict:
    """Wall-clock throughput of the O3 scheduler over the suite's programs
    (NumPy, on the host), the reference's three numbers: ``ops_per_s`` of
    the batched kernel over calibrate's default grid (every combo counts
    as one schedule of the program), ``single_ops_per_s`` of the scalar
    kernel, ``reference_ops_per_s`` of the per-op interpreter.  Programs
    are compiled outside the timed loops."""
    compiled = [compile_program(p, hw, compute_dtype="f64")
                for p in table.programs]
    knobs = calibrate.default_o3_knobs(hw)

    def timed(fn, per_round: int) -> dict:
        n_ops = rounds = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < min_wall_s:
            fn()
            n_ops += per_round
            rounds += 1
        wall = time.perf_counter() - t0
        return {"scheduled_ops": n_ops, "rounds": rounds, "wall_s": wall,
                "ops_per_s": n_ops / wall if wall > 0 else 0.0}

    suite_ops = sum(len(p.ops) for p in table.programs)
    costed = [cost_program(p, hw, compute_dtype="f64")
              for p in table.programs]

    def batched():
        for cp in compiled:
            schedule_batch(cp, knobs)

    def single():
        for cp in compiled:
            schedule_arrays(cp, hw)

    def reference():
        for prog, ops in zip(table.programs, costed):
            schedule_reference(prog, hw, costed=ops)

    res = timed(batched, suite_ops * knobs.batch)
    res["mode"] = "compiled_batched_o3_grid"
    res["grid_combos"] = knobs.batch
    res["single_ops_per_s"] = timed(single, suite_ops)["ops_per_s"]
    res["reference_ops_per_s"] = timed(reference, suite_ops)["ops_per_s"]
    return res


def a64fx_cycles_per_8elem(name: str, n: int) -> float:
    """Simulated single-core A64FX cycles per 8-element operation of one
    launch of ``name`` over ``n`` elements."""
    rep = simulate(calibrate.kernel_program(name, n), hw=A64FX_CORE,
                   n_chips=1, compute_dtype="f64")
    return rep.engine.t_est * 1.8e9 / (n / 8)


def a64fx_node_estimates(name: str, n: int) -> dict:
    """Contention-aware node estimates (shard partition) of one launch on
    the A64FX node topology at 1/12/48 cores."""
    nc = compile_node(calibrate.kernel_program(name, n), A64FX_CORE,
                      compute_dtype="f64")
    out = {}
    for k in NODE_CORE_COUNTS:
        nr = schedule_node(nc, A64FX_CORE, k, partition="shard")
        out[k] = {"t_est_us": nr.t_est * 1e6,
                  "t_zero_contention_us": nr.t_zero_contention * 1e6,
                  "hbm2_n_active": nr.per_cmg[0].n_active.get("hbm2", 1.0)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="every fourth kernel (7 of 28)")
    ap.add_argument("--size-scale", type=int, default=calibrate.SIZE_SCALE)
    ap.add_argument("--device", default="cuda",
                    help="cuda (K1 on the card; raises without one) or cpu "
                         "(the plain K1 functions)")
    ap.add_argument("--out", type=Path, default=BENCH_JSON)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.device import resolve
    device = resolve(args.device)
    kernels = KERNELS[::4] if args.quick else KERNELS

    t0 = time.perf_counter()
    if device.type == "cuda":
        hw = calibrate.fit_h100(device)
    else:
        hw = calibrate.fit_cpu_host(size_scale=args.size_scale)
    print(f"== {hw.name} parameter file fitted on {device} in "
          f"{time.perf_counter() - t0:.1f} s: vpu "
          f"{hw.vpu_flops['f64'] / 1e9:.2f} GFLOP/s f64, hbm read "
          f"{hw.hbm_read_bw / 1e9:.2f} GB/s, write "
          f"{hw.hbm_write_bw / 1e9:.2f} GB/s, llc/l2 {hw.vmem_bw / 1e9:.2f} "
          f"GB/s, startup {hw.op_startup_ns / 1e3:.2f} us ==")

    table = calibrate.kernel_accuracy_table(
        hw, size_scale=args.size_scale, kernels=kernels, keep_programs=True,
        device=device)
    print(table.report())

    thr = scheduler_throughput(table, hw)
    print(f"== scheduler throughput: {thr['ops_per_s']:.0f} ops/s batched "
          f"({thr['grid_combos']} combos), {thr['single_ops_per_s']:.0f} "
          f"single, {thr['reference_ops_per_s']:.0f} reference ==")

    bars, node_rows = {}, {}
    for k in kernels:
        bars[k.name] = a64fx_cycles_per_8elem(k.name, k.n * 8)
        node_rows[k.name] = est = a64fx_node_estimates(k.name, k.n * 8)
        t1, t12, t48 = (est[c]["t_est_us"] for c in NODE_CORE_COUNTS)
        print(f"  {k.name:<8s}{k.ktype:<10s}{bars[k.name]:8.2f} cyc/8elem  "
              f"node 1c {t1:9.2f} us  12c {t12:9.2f} us  48c {t48:9.2f} us")

    out = {
        "card": card() if device.type == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "hw": hw.name,
        "size_scale": args.size_scale,
        "kernels": {r.name: {"measured_us": r.measured_us,
                             "t_est_occupancy_us": r.simulated_us,
                             "t_est_schedule_us": r.simulated_sched_us,
                             "bound_by": r.bound_by,
                             "fit_input": r.fit_input,
                             "a64fx_core_cycles_per_8elem": bars[r.name],
                             "a64fx_node_us": {
                                 str(c): node_rows[r.name][c]["t_est_us"]
                                 for c in NODE_CORE_COUNTS}}
                    for r in table.rows},
        "scheduler_throughput": thr,
        "summary": {
            "mean_diff_pct": table.mean_diff,
            "std_diff_pct": table.std_diff,
            "mean_abs_diff_pct": table.mean_abs_diff,
            "within_10pct": table.within_10pct,
            "sched_mean_abs_diff_pct": table.sched_mean_abs_diff,
            "sched_within_10pct": table.sched_within_10pct,
            "paper": {"mean_diff_pct": PAPER_MEAN_DIFF_PCT,
                      "std_diff_pct": PAPER_STD_DIFF_PCT,
                      "mean_abs_diff_pct": PAPER_MEAN_ABS_DIFF_PCT,
                      "within_10pct": PAPER_WITHIN_10PCT_FRACTION},
        },
        "calibrated": {
            "vpu_gflops": hw.vpu_flops["f64"] / 1e9,
            "hbm_read_gbps": hw.hbm_read_bw / 1e9,
            "hbm_write_gbps": hw.hbm_write_bw / 1e9,
            "llc_gbps": hw.vmem_bw / 1e9,
            "startup_us": hw.op_startup_ns / 1e3,
            "opcode_factor": hw.opcode_factor,
        },
    }
    args.out.write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

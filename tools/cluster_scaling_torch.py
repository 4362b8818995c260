"""Cluster scaling study on the port: parallel plans over a TofuD-style mesh.

    PYTHONPATH=src python3 tools/cluster_scaling_torch.py           # full
    PYTHONPATH=src python3 tools/cluster_scaling_torch.py --quick   # smoke

The port's counterpart of ``benchmarks/cluster_scaling.py``: the cluster
engine (``core.cluster``) prices tensor/data/pipeline-parallel train plans
as scheduled collectives overlapping compute, shard axes resolved by the
port's ``parallel.sharding.MeshRules`` (``core.zoo.mesh_rules_resolver``).
Host code (NumPy); it runs no kernel and takes no ``--device``.

The full run sweeps grok-1-314b and nemotron-4-340b from 2 to 1024 nodes
over the zoo's train traces (captured on the CPU, cached under
``experiments/zoo_programs/``) and writes ``--out`` (default
``BENCH_cluster_torch.json``) in ``BENCH_cluster.json``'s schema, plus a
``"reference"`` block: at each node count whether the model rank and each
model's winning plan equal the committed ``BENCH_cluster.json``'s, and the
Kendall tau between the two packages' plan rankings.  ``--quick`` runs the
reference's synthetic collective-free DAG at 2 and 8 nodes and writes
``BENCH_cluster_torch_quick.json``; its numbers must equal the
reference's ``--quick`` (``tools/cluster_quick_reference.json``, which
``tests/test_torch_cluster_drivers.py`` holds to the reference's own
run).  Both modes enforce the reference's sanity floors and exit 1 if one
fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from repro_torch.core.cluster import ClusterWorkload, cluster_sweep  # noqa: E402
from repro_torch.core.zoo import (DEFAULT_CLUSTER_MODELS,  # noqa: E402
                                  DEFAULT_NODE_COUNTS, ClusterReport,
                                  kendall_tau, run_cluster)

BENCH_JSON = ROOT / "BENCH_cluster_torch.json"
QUICK_JSON = ROOT / "BENCH_cluster_torch_quick.json"
REFERENCE_JSON = ROOT / "BENCH_cluster.json"
QUICK_REFERENCE = ROOT / "tools" / "cluster_quick_reference.json"
PROGRAM_CACHE = ROOT / "experiments" / "zoo_programs"
QUICK_N_OPS = 256
QUICK_NODE_COUNTS = (2, 8)
QUICK_EFFICIENCY_FLOOR = 0.5


def quick_report() -> ClusterReport:
    """The reference's smoke: a synthetic DAG dressed as a 4-layer model."""
    from sched_throughput_torch import synthetic_program
    prog = synthetic_program(QUICK_N_OPS, seed=0)
    w = ClusterWorkload(
        name="synthetic", prog=prog, repeats=8, layers=4, d_model=512,
        seq_len=128, batch=2, param_bytes=64e6, frac_attn=0.4)
    report = ClusterReport(
        hw="a64fx_core", topology="a64fx_node", cluster="tofu_d",
        n_cores=48, compute_dtype="f32",
        node_counts=QUICK_NODE_COUNTS)
    t0 = time.perf_counter()
    report.results[w.name] = cluster_sweep(
        w, QUICK_NODE_COUNTS, n_cores=48, max_tp=4, max_pp=2)
    report.wall_s = time.perf_counter() - t0
    return report


def check_sanity(report: ClusterReport, efficiency_floor: float) -> list:
    """The reference's invariants; returns failure strings."""
    fails = []
    for model, rows in report.results.items():
        for r in rows:
            tag = f"{model} N={r.n_nodes} {r.plan.label}"
            if not (0.0 < r.parallel_efficiency <= 1.0 + 1e-9):
                fails.append(f"{tag}: efficiency "
                             f"{r.parallel_efficiency:.3f} outside (0, 1]")
            if not (r.t_step_s > 0.0 and r.t_step_s < float("inf")):
                fails.append(f"{tag}: non-finite step time {r.t_step_s}")
            if r.t_step_s + 1e-12 < r.t_floor_s:
                fails.append(f"{tag}: step {r.t_step_s:.3e} beats its "
                             f"compute floor {r.t_floor_s:.3e}")
        n0 = report.node_counts[0]
        dp_only = [r for r in rows
                   if r.n_nodes == n0 and r.plan.tp == 1 and r.plan.pp == 1]
        for r in dp_only:
            if r.parallel_efficiency < efficiency_floor:
                fails.append(
                    f"{model} N={n0} {r.plan.label}: DP efficiency "
                    f"{r.parallel_efficiency:.3f} below the "
                    f"{efficiency_floor:.2f} floor")
    return fails


def sweep_numbers(payload: dict) -> dict:
    """Every plan's numbers of a ``to_dict`` payload (no wall clock)."""
    return {m: v["plans"] for m, v in payload["models"].items()}


def against_reference(ours: dict, ref: dict) -> dict:
    """Per node count: the model rank and each model's best plan, equal or
    not, and per model the Kendall tau between the two plan rankings."""
    out = {"rank_equal": {}, "best_plan_equal": {}, "plan_tau": {}}
    for n, rank in ours["rank"].items():
        out["rank_equal"][n] = rank == ref["rank"].get(n)
    for m, v in ours["models"].items():
        rv = ref["models"].get(m)
        if rv is None:
            continue
        out["best_plan_equal"][m] = {
            n: p == rv["best_plan"].get(n) for n, p in v["best_plan"].items()}
        taus = {}
        for n, plans in v["plans"].items():
            common = sorted(set(plans) & set(rv["plans"].get(n, {})))
            if len(common) >= 2:
                taus[n] = kendall_tau(
                    [plans[p]["t_step_us"] for p in common],
                    [rv["plans"][n][p]["t_step_us"] for p in common])
        out["plan_tau"][m] = taus
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help=f"synthetic smoke; writes {QUICK_JSON.name}")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--efficiency-floor", type=float,
                    default=QUICK_EFFICIENCY_FLOOR,
                    help="minimum 2-node pure-DP parallel efficiency")
    ap.add_argument("--no-cache", action="store_true",
                    help="always recapture (ignore experiments/zoo_programs/)")
    args = ap.parse_args(argv)

    if args.quick:
        print(f"== cluster scaling: synthetic smoke at "
              f"{QUICK_NODE_COUNTS} nodes ==")
        report = quick_report()
        target = args.out or QUICK_JSON
    else:
        cache = None if args.no_cache else PROGRAM_CACHE
        print(f"== cluster scaling: {DEFAULT_CLUSTER_MODELS} over "
              f"{DEFAULT_NODE_COUNTS} nodes ==")
        report = run_cluster(
            hlo_cache_dir=cache,
            progress=lambda m, msg: print(f"  {m}: {msg}", flush=True))
        target = args.out or BENCH_JSON

    out = report.to_dict()
    out["mode"] = "quick" if args.quick else "full"
    fails = check_sanity(report, args.efficiency_floor)
    if args.quick:
        want = json.loads(QUICK_REFERENCE.read_text())
        out["reference_equal"] = sweep_numbers(out) == sweep_numbers(want)
        if not out["reference_equal"]:
            fails.append("the --quick numbers differ from the reference's "
                         f"({QUICK_REFERENCE.name})")
    else:
        out["reference"] = against_reference(
            out, json.loads(REFERENCE_JSON.read_text()))
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(json.dumps(out, indent=1))

    for model in report.results:
        print(f"{model}:")
        for n in report.node_counts:
            if not report.cells(model, n):
                continue
            b = report.best(model, n)
            print(f"  N={n:5d} best {b.plan.label:16s} "
                  f"t_step {b.t_step_s * 1e3:9.3f} ms  "
                  f"eff {b.parallel_efficiency:5.3f}  "
                  f"tok/s {b.tokens_per_s:12,.0f}")
        taus = report.plan_rank_stability(model)
        print(f"  plan-rank tau min {taus['min']:+.3f}")
    if "reference" in out:
        print("against BENCH_cluster.json: " + json.dumps(out["reference"]))
    print(f"wrote {target} ({report.wall_s:.1f}s sweep)")

    if fails:
        for f in fails:
            print(f"FAIL: {f}")
        return 1
    print("OK: all scaling-sanity floors hold")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

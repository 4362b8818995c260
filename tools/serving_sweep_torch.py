"""Serving sweep on the port: SLO percentiles + Pareto fronts over scheduler
policies.  Host code: it needs no card.

    PYTHONPATH=src python3 tools/serving_sweep_torch.py [--quick]

The port's counterpart of ``benchmarks/serving_sweep.py`` (DESIGN.md §21):
the continuous-batching simulator (``core.serving``) over zoo models x
scheduler knobs.  Each model's phase costs come from the node engine
(``build_zoo_cost_model``: prefill µs/token and a decode-batch latency
grid, from the port's ATen captures of the reduced model, each (arch,
phase, batch) cell cached under ``experiments/serving_cost_torch/``), its
KV working set from the FULL config's cache spec tree
(``kvcache.kv_token_bytes``); the open-loop Poisson arrival rate is
``LOAD_FACTOR`` times the batch-1 service rate.  Every time it reports is
an estimate for an A64FX node (48 cores), not a time on any card: the
simulator and its cost model run on the host, so no card is needed and
nothing on a card is skipped.

Full mode writes ``--out`` (default ``BENCH_serving_torch.json``; the
``BENCH_serving.json`` schema plus ``card`` and ``vs_reference``: each
model's Pareto front and best policy beside the reference's committed
``BENCH_serving.json``).  ``--quick`` writes
``BENCH_serving_torch_quick.json`` from a synthetic cost model — the same
payload as the reference's ``--quick`` but for ``wall_s`` — and FAILS when
the run blows ``--budget`` seconds, when batching stops paying (b=8 under
1.5x the b=1 tokens/s), or when any run's Little's-law gap opens.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.core.serving import (LengthDist, ServingKnobs,  # noqa: E402
                                      SyntheticCostModel,
                                      build_zoo_cost_model, pareto_front,
                                      poisson_requests, simulate_serving,
                                      traffic_for)
from sched_throughput_torch import card  # noqa: E402

BENCH_JSON = Path("BENCH_serving_torch.json")
QUICK_JSON = Path("BENCH_serving_torch_quick.json")
REFERENCE_JSON = Path(__file__).resolve().parents[1] / "BENCH_serving.json"
PROGRAM_CACHE = Path("experiments/zoo_programs")
COST_CACHE = Path("experiments/serving_cost_torch")
FULL_MODELS = ("chatglm3-6b", "qwen1.5-32b", "llama4-scout-17b-a16e",
               "mamba2-1.3b")
POLICIES = (
    ServingKnobs(max_batch=1),
    ServingKnobs(max_batch=8),
    ServingKnobs(max_batch=32),
    ServingKnobs(max_batch=32, admission="spf"),
    ServingKnobs(max_batch=32, prefill_chunk=256),
    ServingKnobs(max_batch=32, eviction="evict-oldest"),
)
N_REQUESTS = 600
LOAD_FACTOR = 2.5            # arrival rate as a multiple of the batch-1
                             # service rate: saturates b=1, leaves the
                             # batched policies finite headroom
SEED = 0
QUICK_BATCH_GAIN = 1.5       # b=8 must beat b=1 tokens/s by this factor


def batch1_service_time(cost, traffic: LengthDist) -> float:
    """Mean batch-1 service time: one prefill + (out-1) decode steps at
    the mean lengths — the rate anchor for the open-loop sweep."""
    p, o = traffic.prompt_mean, traffic.out_mean
    kv = cost.kv_bytes(1, p + o)
    return cost.prefill_time(int(p)) \
        + max(0.0, o - 1) * cost.decode_step_time(1, kv)


def sweep_model(cost, traffic: LengthDist, n: int, load: float,
                seed: int) -> dict:
    """Run every policy on one arrival trace; returns the per-model row
    (metrics per policy label + the Pareto front)."""
    s1 = batch1_service_time(cost, traffic)
    rate = load / s1
    reqs = poisson_requests(n, rate, traffic, seed=seed)
    metrics = {}
    for knobs in POLICIES:
        res = simulate_serving(reqs, cost, knobs)
        m = res.metrics()
        if m["little_law_gap"] >= 1e-6:
            raise SystemExit(f"Little's-law gap {m['little_law_gap']:.2e} "
                             f"at {knobs.label}: bookkeeping leak")
        metrics[knobs.label] = m
    labels = list(metrics)
    pts = [(metrics[lb]["p99_ttft_ms"], -metrics[lb]["tokens_per_s"])
           for lb in labels]
    return {
        "traffic": dataclasses.asdict(traffic),
        "rate_per_s": rate,
        "batch1_service_s": s1,
        "bytes_per_token": cost.bytes_per_token,
        "bytes_per_request": cost.bytes_per_request,
        "policies": metrics,
        "pareto": [labels[i] for i in pareto_front(pts)],
    }


def policy_rows() -> list:
    return [{"label": k.label, "max_batch": k.max_batch,
             "admission": k.admission, "prefill_chunk": k.prefill_chunk,
             "eviction": k.eviction} for k in POLICIES]


def run_quick(budget: float) -> dict:
    """Synthetic affine costs, two traffic mixes, the full policy grid,
    with throughput/bookkeeping/wall gates."""
    t0 = time.perf_counter()
    # 20 kB/token keeps the mix compute-bound (realistic zoo KV scale);
    # at 1 MB/token the decode path is pure HBM streaming and batching
    # cannot pay by construction
    cost = SyntheticCostModel(prefill_t0=2e-4, prefill_per_token=1e-5,
                              decode_t0=1e-4, decode_per_seq=2e-5,
                              bytes_per_token=2e4, bytes_per_request=5e6)
    # both mixes are decode-weighted: batching only parallelizes decode
    # (prefill serializes an iteration), so a prompt-dominated mix caps
    # the b=8 gain at s1/prefill regardless of the scheduler
    mixes = {"chat": LengthDist(256, 0.8, 128, 0.6),
             "decode-heavy": LengthDist(512, 1.0, 256, 0.6)}
    models = {name: sweep_model(cost, tr, 2_000, LOAD_FACTOR, SEED)
              for name, tr in mixes.items()}
    wall = time.perf_counter() - t0
    for name, row in models.items():
        t1 = row["policies"]["fcfs_b1"]["tokens_per_s"]
        t8 = row["policies"]["fcfs_b8"]["tokens_per_s"]
        if t8 < QUICK_BATCH_GAIN * t1:
            raise SystemExit(f"{name}: b=8 tokens/s {t8:.0f} < "
                             f"{QUICK_BATCH_GAIN}x b=1 {t1:.0f}")
    if wall > budget:
        raise SystemExit(f"quick sweep took {wall:.1f}s > budget {budget}s")
    return {
        "schema": 1, "mode": "quick",
        "arrival": {"n_requests": 2_000, "load_factor": LOAD_FACTOR,
                    "seed": SEED},
        "policies": policy_rows(),
        "models": models,
        "wall_s": wall,
    }


def run_full(models, n: int, program_cache=PROGRAM_CACHE,
             cost_cache=COST_CACHE) -> dict:
    """Every model of ``models`` priced from its captures and swept over
    ``POLICIES`` at ``n`` requests."""
    t0 = time.perf_counter()
    rows = {}
    for arch in models:
        t1 = time.perf_counter()
        cost = build_zoo_cost_model(arch, hlo_cache_dir=program_cache,
                                    cost_cache_dir=cost_cache)
        rows[arch] = sweep_model(cost, traffic_for(arch), n,
                                 LOAD_FACTOR, SEED)
        rows[arch]["prefill_us_per_token"] = cost.prefill_per_token * 1e6
        rows[arch]["decode_grid_us"] = [[b, t * 1e6]
                                        for b, t in cost.decode_grid]
        rows[arch]["wall_s"] = time.perf_counter() - t1
        print(f"{arch:28s} {rows[arch]['wall_s']:6.1f}s  "
              f"pareto: {', '.join(rows[arch]['pareto'])}", flush=True)
    return {
        "schema": 1, "mode": "full",
        "arrival": {"n_requests": n, "load_factor": LOAD_FACTOR,
                    "seed": SEED},
        "policies": policy_rows(),
        "models": rows,
        "wall_s": time.perf_counter() - t0,
    }


def best_policy(row: dict) -> str:
    """The policy with the most tokens/s in one model's row."""
    return max(row["policies"].items(),
               key=lambda kv: kv[1]["tokens_per_s"])[0]


def against_reference(ref: dict, got: dict) -> dict:
    """Per model both payloads hold: the two Pareto fronts and best
    policies, and the port's prefill µs/token and bytes/token beside the
    reference's."""
    out = {}
    for arch, row in got["models"].items():
        theirs = ref.get("models", {}).get(arch)
        if theirs is None:
            continue
        out[arch] = {
            "pareto": row["pareto"], "reference_pareto": theirs["pareto"],
            "best_policy": best_policy(row),
            "reference_best_policy": best_policy(theirs),
            "prefill_us_per_token": row.get("prefill_us_per_token"),
            "reference_prefill_us_per_token":
                theirs.get("prefill_us_per_token"),
            "bytes_per_token": row["bytes_per_token"],
            "reference_bytes_per_token": theirs["bytes_per_token"],
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="Host code: needs no card. Its times are A64FX-node "
               "estimates of each model, not card times.")
    ap.add_argument("--quick", action="store_true",
                    help="synthetic cost model, no capture")
    ap.add_argument("--budget", type=float, default=60.0,
                    help="--quick wall-clock budget in seconds")
    ap.add_argument("--models", nargs="*", default=list(FULL_MODELS))
    ap.add_argument("--n", type=int, default=N_REQUESTS,
                    help="requests per (model, policy) run")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    if args.quick:
        out = run_quick(args.budget)
        target = args.out or QUICK_JSON
        target.write_text(json.dumps(out, indent=1))
        print(f"wrote {target} ({out['wall_s']:.2f}s)")
        return 0

    out = run_full(args.models, args.n)
    out["card"] = card()
    out["times"] = ("A64FX-node estimates (48 cores) of each model from "
                    "the node engine, not card times")
    out["vs_reference"] = against_reference(
        json.loads(REFERENCE_JSON.read_text()), out)
    target = args.out or BENCH_JSON
    target.write_text(json.dumps(out, indent=1))
    print(f"wrote {target} ({out['wall_s']:.1f}s)")
    for arch, row in out["models"].items():
        best = best_policy(row)
        m = row["policies"][best]
        vs = out["vs_reference"].get(arch)
        print(f"{arch:28s} best {best:22s} {m['tokens_per_s']:9.1f} tok/s  "
              f"p99 TTFT {m['p99_ttft_ms']:9.1f} ms"
              + (f"  (reference best {vs['reference_best_policy']}, "
                 f"pareto {', '.join(vs['reference_pareto'])})"
                 if vs else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())

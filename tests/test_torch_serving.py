"""``repro_torch.core.serving`` and the zoo's serving cells against
``repro.core.serving`` and ``repro.core.zoo``.

The event loop is deterministic host code, so it is held bit for bit: for
each of the serving sweep's six policies and both quick traffic mixes, the
two packages' ``simulate_serving`` on identical requests and an identical
``SyntheticCostModel`` give identical ``metrics()`` dicts; so do a pool
small enough that every KV policy rejects or evicts, and a trace-driven
run.  Also: ``poisson_requests``, ``percentile``, ``node_kv_levels``,
``pareto_front``, ``ZooCostModel``'s interpolation and extrapolation,
``build_zoo_cost_model`` on shared cell costs, its bytes per token on the
port's own capture, and the phase-keyed ``serving_cell_cost`` cache.
"""
import dataclasses
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.sched_throughput import synthetic_program
from repro.configs import ARCHS as REF_ARCHS
from repro.core import serving as ref
from repro.core import zoo as ref_zoo
from repro.models.lm import build_model as ref_build_model
from repro.serve.kvcache import kv_token_bytes as ref_kv_token_bytes
from repro_torch.configs import ARCHS, ZOO_SHAPES
from repro_torch.core import hlo as pt_hlo
from repro_torch.core import serving
from repro_torch.core import zoo

BENCH_SERVING = Path(__file__).resolve().parents[1] / "BENCH_serving.json"
# the serving sweep's policy grid and quick mixes
# (benchmarks/serving_sweep.py), as keyword tuples
POLICIES = ({"max_batch": 1}, {"max_batch": 8}, {"max_batch": 32},
            {"max_batch": 32, "admission": "spf"},
            {"max_batch": 32, "prefill_chunk": 256},
            {"max_batch": 32, "eviction": "evict-oldest"})
MIXES = {"chat": (256, 0.8, 128, 0.6), "decode-heavy": (512, 1.0, 256, 0.6)}
COST = dict(prefill_t0=2e-4, prefill_per_token=1e-5, decode_t0=1e-4,
            decode_per_seq=2e-5, bytes_per_token=2e4, bytes_per_request=5e6)
FULL_MODELS = ("chatglm3-6b", "qwen1.5-32b", "llama4-scout-17b-a16e",
               "mamba2-1.3b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same(a: dict, b: dict) -> bool:
    """Equal dicts, a NaN equal to a NaN (``repr`` round-trips a float
    exactly)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def both_runs(mix, policy, n=400, rate=None, **cost_kw):
    """The same Poisson trace and cost model through both packages;
    returns the two ``metrics()`` dicts."""
    kw = {**COST, **cost_kw}
    out = []
    for pkg in (ref, serving):
        lengths = pkg.LengthDist(*mix)
        cost = pkg.SyntheticCostModel(**kw)
        reqs = pkg.poisson_requests(n, rate or 40.0, lengths, seed=3)
        out.append(pkg.simulate_serving(reqs, cost,
                                        pkg.ServingKnobs(**policy)).metrics())
    return out


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("policy", POLICIES,
                         ids=lambda p: "_".join(f"{v}" for v in p.values()))
def test_simulate_serving_metrics_match_the_reference(mix, policy):
    want, got = both_runs(MIXES[mix], policy)
    assert got == want
    assert got["completed"] + got["rejected"] == 400
    assert got["little_law_gap"] < 1e-6


@pytest.mark.parametrize("eviction", ["reject", "evict-oldest",
                                      "evict-newest"])
def test_a_small_kv_pool_rejects_or_evicts_alike(eviction):
    """A pool of ~12 requests' footprint: ``reject`` turns some requests
    away, the evict policies preempt and re-prefill; bit for bit."""
    policy = {"max_batch": 32, "eviction": eviction}
    want, got = both_runs(MIXES["decode-heavy"], policy, n=300, rate=200.0,
                          kv_capacity=12 * (5e6 + 2e4 * 600))
    assert got == want
    if eviction == "reject":
        assert got["max_kv_gb"] * 2**30 <= 12 * (5e6 + 2e4 * 600)
    else:
        assert got["n_evictions"] > 0
    tiny = both_runs(MIXES["chat"], policy, n=50, kv_capacity=6e6)
    assert same(tiny[1], tiny[0]) and tiny[1]["rejected"] > 0


def test_a_trace_driven_run_matches_the_reference(tmp_path):
    rng = np.random.default_rng(4)
    rows, t = [], 0.0
    for i in range(200):
        t += float(rng.exponential(0.02))
        rows.append({"rid": 1000 - i, "t_arrival": t,
                     "prompt_tokens": int(rng.integers(1, 600)),
                     "out_tokens": int(rng.integers(1, 200))})
    rows[5]["t_arrival"] = rows[4]["t_arrival"]          # a tie in time
    path = tmp_path / "trace.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    got_reqs = serving.load_trace_jsonl(path)
    want_reqs = ref.load_trace_jsonl(path)
    assert [dataclasses.astuple(r) for r in got_reqs] \
        == [dataclasses.astuple(r) for r in want_reqs]
    knobs = dict(max_batch=8, prefill_chunk=128, admission="spf")
    want = ref.simulate_serving(want_reqs, ref.SyntheticCostModel(**COST),
                                ref.ServingKnobs(**knobs))
    got = serving.simulate_serving(got_reqs,
                                   serving.SyntheticCostModel(**COST),
                                   serving.ServingKnobs(**knobs))
    assert got.metrics() == want.metrics()
    assert [(s.t_admit, s.t_first, s.t_done) for s in got.stats] \
        == [(s.t_admit, s.t_first, s.t_done) for s in want.stats]
    assert serving.requests_from_trace([{"t_arrival": 1, "prompt_tokens": 2,
                                         "out_tokens": 3}])[0].rid == 0


@pytest.mark.parametrize("mix", sorted(MIXES) + ["constant"])
def test_poisson_requests_are_the_references(mix):
    args = MIXES.get(mix, (100, 0.0, 20, 0.0))
    for seed in (0, 1, 7):
        got = serving.poisson_requests(500, 12.5,
                                       serving.LengthDist(*args), seed)
        want = ref.poisson_requests(500, 12.5, ref.LengthDist(*args), seed)
        assert [dataclasses.astuple(r) for r in got] \
            == [dataclasses.astuple(r) for r in want]


def test_percentile_and_pareto_front_match_the_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 9, 100):
        xs = list(rng.random(n))
        for q in (0, 1, 50, 99, 99.9, 100):
            a, b = serving.percentile(xs, q), ref.percentile(xs, q)
            assert a == b or (math.isnan(a) and math.isnan(b))
        pts = [tuple(map(float, rng.integers(0, 4, 2))) for _ in range(n)]
        assert serving.pareto_front(pts) == ref.pareto_front(pts)


def test_tables_and_levels_match_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in
            serving.ZOO_TRAFFIC.items()} \
        == {k: dataclasses.astuple(v) for k, v in ref.ZOO_TRAFFIC.items()}
    for arch in ("chatglm3-6b", "zamba2-1.2b"):
        assert dataclasses.astuple(serving.traffic_for(arch)) \
            == dataclasses.astuple(ref.traffic_for(arch))
    assert serving.DECODE_BATCH_GRID == ref.DECODE_BATCH_GRID
    assert serving.MAX_EVICTIONS_PER_REQUEST == ref.MAX_EVICTIONS_PER_REQUEST
    got, want = serving.node_kv_levels(), ref.node_kv_levels()
    assert [dataclasses.asdict(lv) for lv in got] \
        == [dataclasses.asdict(lv) for lv in want]
    assert [lv.name for lv in got] == ["l2", "hbm2"]
    assert [lv.name for lv in serving.SyntheticCostModel().levels] \
        == ["l2", "hbm2"]


def test_zoo_cost_model_interpolates_and_extrapolates_alike():
    grid = ((1, 1e-3), (4, 1.6e-3), (16, 5.1e-3), (64, 1.3e-2))
    kw = dict(arch="x", prefill_per_token=3e-6, decode_grid=grid,
              bytes_per_token=28672.0, bytes_per_request=1e5)
    got, want = serving.ZooCostModel(**kw), ref.ZooCostModel(**kw)
    for b in list(range(0, 70)) + [100, 257]:
        assert got.decode_compute_time(b) == want.decode_compute_time(b)
        assert got.decode_step_time(b, got.kv_bytes(b, 300 * b)) \
            == want.decode_step_time(b, want.kv_bytes(b, 300 * b))
    assert got.decode_compute_time(100) > grid[-1][1]      # final slope
    assert got.prefill_time(777) == want.prefill_time(777)
    one = dict(kw, decode_grid=((4, 2e-3),))
    assert serving.ZooCostModel(**one).decode_compute_time(9) == 2e-3


def _ref_bytes(arch):
    return ref_kv_token_bytes(ref_build_model(REF_ARCHS[arch]), jnp.bfloat16)


@pytest.mark.parametrize("arch", FULL_MODELS)
def test_build_zoo_cost_model_matches_the_reference_on_shared_cells(
        monkeypatch, arch):
    """Both packages' ``build_zoo_cost_model`` with the same cell costs:
    the layer scale, prefill seconds a token, decode grid, KV bytes from
    each package's FULL config spec tree, levels and pool capacity."""
    cells = []

    def cell(arch_, phase, shape, *rest):
        cells.append((phase, shape.seq_len, shape.global_batch, rest[0]))
        return (1e-4 if phase == "prefill" else 2e-5) \
            * (1 + shape.global_batch) ** 0.5

    monkeypatch.setattr(ref_zoo, "serving_cell_cost", cell)
    monkeypatch.setattr(zoo, "serving_cell_cost", cell)
    want = ref.build_zoo_cost_model(arch)
    n_ref = list(cells)
    got = serving.build_zoo_cost_model(arch)
    assert cells[len(n_ref):] == n_ref
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_scale == zoo.long_trace_repeats(arch, "prefill")


def test_build_zoo_cost_model_on_the_ports_capture(tmp_path):
    """chatglm3-6b priced from the port's own captures: KV bytes equal the
    reference's cache tree (28,672 bytes a token in BENCH_serving.json),
    the grid is positive and sorted, and a second build reads every cell
    from the cost cache without capturing."""
    got = serving.build_zoo_cost_model("chatglm3-6b",
                                       cost_cache_dir=tmp_path)
    per_tok, per_req = _ref_bytes("chatglm3-6b")
    bench = json.loads(BENCH_SERVING.read_text())["models"]["chatglm3-6b"]
    assert (got.bytes_per_token, got.bytes_per_request) \
        == (per_tok, per_req) == (bench["bytes_per_token"],
                                  bench["bytes_per_request"]) \
        == (28672.0, 0.0)
    assert [b for b, _ in got.decode_grid] == [1, 4, 16, 64]
    assert all(t > 0 for _, t in got.decode_grid) and got.prefill_per_token > 0
    assert len(list(tmp_path.glob("*.json"))) == 5
    zoo.clear_trace_caches()
    again = serving.build_zoo_cost_model("chatglm3-6b",
                                         cost_cache_dir=tmp_path)
    assert dataclasses.asdict(again) == dataclasses.asdict(got)


@pytest.mark.parametrize("arch", FULL_MODELS[1:])
def test_kv_bytes_of_the_full_configs_match_the_reference(arch):
    from repro_torch.models.lm import LM
    from repro_torch.serve.kvcache import kv_token_bytes
    got = kv_token_bytes(LM(ARCHS[arch]), torch.bfloat16)
    bench = json.loads(BENCH_SERVING.read_text())["models"][arch]
    assert got == _ref_bytes(arch) \
        == (bench["bytes_per_token"], bench["bytes_per_request"])


def test_serving_cost_key_is_distinct_by_phase(tmp_path):
    shape = dataclasses.replace(ZOO_SHAPES["prefill"], name="alias")
    keys = {ph: zoo.serving_cost_key("chatglm3-6b", ph, shape, 48, "f32",
                                     "float32")
            for ph in ("prefill", "decode")}
    assert keys["prefill"] != keys["decode"]
    assert (ZOO_SHAPES["prefill"].seq_len,
            ZOO_SHAPES["prefill"].global_batch) \
        == (ZOO_SHAPES["decode"].seq_len, ZOO_SHAPES["decode"].global_batch)
    assert zoo.serving_cost_key("chatglm3-6b", "decode", shape, 12, "f32",
                                "float32") != keys["decode"]
    assert zoo.SERVING_COST_SCHEMA == 1


def test_serving_cell_cost_matches_the_reference_and_caches(monkeypatch,
                                                            tmp_path):
    """One shared program for each phase through both packages'
    ``serving_cell_cost`` (48 cores, shard): the same bits; each phase in
    its own cache file; a cached cell returns without tracing."""
    progs = {}
    for i, ph in enumerate(("prefill", "decode")):
        p = synthetic_program(300, seed=20 + i)
        progs[ph] = (p, pt_hlo.Program(
            ops=[pt_hlo.OpStat(**dataclasses.asdict(o)) for o in p.ops],
            entry=p.entry, n_partitions=p.n_partitions))
    traced = []

    def fake(which):
        def trace(arch, phase, shape=None, param_dtype="float32",
                  hlo_cache_dir=None):
            traced.append((which, phase))
            return progs[phase][which]
        return trace

    monkeypatch.setattr(ref_zoo, "trace_phase", fake(0))
    monkeypatch.setattr(zoo, "trace_phase", fake(1))
    shape = ZOO_SHAPES["prefill"]
    for ph in ("prefill", "decode"):
        want = ref_zoo.serving_cell_cost("chatglm3-6b", ph, shape)
        got = zoo.serving_cell_cost("chatglm3-6b", ph, shape,
                                    cost_cache_dir=tmp_path)
        assert got == want > 0
    files = sorted(f.name for f in tmp_path.glob("*.json"))
    assert len(files) == 2 and "serve_prefill" in files[1] \
        and "serve_decode" in files[0]
    n = len(traced)
    again = zoo.serving_cell_cost("chatglm3-6b", "decode", shape,
                                  cost_cache_dir=tmp_path)
    assert len(traced) == n and again == got
    row = json.loads((tmp_path / files[0]).read_text())
    assert row["phase"] == "decode" and row["schema"] == 1

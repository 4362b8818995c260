"""``repro_torch.core.sample`` against ``repro.core.sample``, bit for bit.

The same programs go through both packages: the same ``OpStat`` lists (the
reference's perf-smoke DAG, copied field by field into the port's
``OpStat``), and the same HLO text through each package's
``parse_program``.  Held equal: the intervals, signatures, seeded k-means
labels, representatives and weights; the sampled estimates and sweeps
(NumPy, and the port's scan through its plain version on the CPU); and
``simulate(sampling=)``'s JSON.  The properties of
``tests/test_sampling.py`` that need no ``repro.core.calibrate`` are
restated on the port.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from benchmarks.sched_throughput import synthetic_program
from repro.core import compiled as ref_compiled
from repro.core import hlo as ref_hlo
from repro.core import hwspec as ref_hw
from repro.core import sample as ref_sample
from repro.core import simulate as ref_simulate
from repro_torch.core import aten
from repro_torch.core import compiled as pt_compiled
from repro_torch.core import cost as pt_cost
from repro_torch.core import hlo as pt_hlo
from repro_torch.core import hwspec as pt_hw
from repro_torch.core import node as pt_node
from repro_torch.core import sample as pt_sample
from repro_torch.core import simulate as pt_simulate
from tests.test_sampling import STUB_HLO

DT = "f64"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(prog):
    """The reference's Program as the port's, field for field."""
    return pt_hlo.Program(
        ops=[pt_hlo.OpStat(**dataclasses.asdict(o)) for o in prog.ops],
        entry=prog.entry, n_partitions=prog.n_partitions)


def both(n=250, seed=3, repeats=1):
    """The perf-smoke DAG (unrolled ``repeats`` times) in both packages,
    and one step's op instances."""
    step = synthetic_program(n, seed=seed)
    inst = sum(o.count for o in step.ops)
    ref = ref_sample.unroll_program(step, repeats)
    return ref, pt_sample.unroll_program(to_port(step), repeats), inst


def counted():
    """A program whose ``count`` changes (a collapsed loop body), as XLA
    writes one."""
    ops = [ref_hlo.OpStat(f"o{i}", "add", "elementwise", "f32", flops=1e6,
                          bytes_accessed=1e4, read_bytes=6e3,
                          write_bytes=4e3,
                          count=8.0 if 18 <= i < 30 else 1.0,
                          deps=[i - 1] if i else [],
                          dep_bytes=[4e3] if i else [])
           for i in range(40)]
    ref = ref_hlo.Program(ops=ops, entry="e", n_partitions=1)
    return ref, to_port(ref)


def assert_plans_equal(got, want):
    assert [dataclasses.astuple(iv) for iv in got.intervals] \
        == [dataclasses.astuple(iv) for iv in want.intervals]
    for name in ("signatures", "labels", "reps", "weights"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert (got.k, got.n_ops, got.n_instances) \
        == (want.k, want.n_ops, want.n_instances)
    assert [len(p.ops) for p in got.rep_programs] \
        == [len(p.ops) for p in want.rep_programs]
    for gp, wp in zip(got.rep_programs, want.rep_programs):
        assert [(o.deps, o.dep_bytes) for o in gp.ops] \
            == [(o.deps, o.dep_bytes) for o in wp.ops]


CONFIGS = {
    "auto_k": dict(interval_ops=64.0),
    "k4_seed11": dict(interval_ops=48.0, k=4, seed=11),
    "k_ge_n": dict(interval_ops=64.0, k=10 ** 9),
    "no_phases": dict(interval_ops=100.0, phase_aware=False),
}


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_plan_matches_the_reference(cfg):
    """Intervals, signatures, k-means labels, representatives and weights
    at a fixed seed, on a random DAG and on a program with phase
    boundaries."""
    for ref, port in (both(400, seed=2)[:2], counted()):
        want = ref_sample.sample_program(
            ref, ref_hw.A64FX_CORE, ref_sample.SamplingConfig(**CONFIGS[cfg]),
            DT)
        got = pt_sample.sample_program(
            port, pt_hw.A64FX_CORE, pt_sample.SamplingConfig(**CONFIGS[cfg]),
            DT)
        assert_plans_equal(got, want)


def test_phase_boundaries_and_slicing_match_the_reference():
    ref, port = counted()
    assert np.array_equal(pt_sample.phase_boundaries(port),
                          ref_sample.phase_boundaries(ref))
    assert set(pt_sample.phase_boundaries(port).tolist()) == {18, 30}
    for kw in (dict(phase_aware=True, snap_frac=0.5), dict(phase_aware=False)):
        got = pt_sample.slice_intervals(port, 20.0, **kw)
        want = ref_sample.slice_intervals(ref, 20.0, **kw)
        assert [dataclasses.astuple(i) for i in got] \
            == [dataclasses.astuple(i) for i in want]
    assert 18 in {iv.start for iv in pt_sample.slice_intervals(
        port, 20.0, phase_aware=True, snap_frac=0.5)[1:]}


@pytest.mark.parametrize("k", [1, 3, 7, 50])
def test_kmeans_and_choose_k_match_the_reference(k):
    X = np.random.RandomState(k).rand(40, 6)
    for got, want in zip(pt_sample.kmeans(X, k, seed=7),
                         ref_sample.kmeans(X, k, seed=7)):
        assert np.array_equal(got, want)
    for got, want in zip(pt_sample.choose_k(X, k, seed=3),
                         ref_sample.choose_k(X, k, seed=3)):
        assert np.array_equal(got, want)


def test_k_ge_n_intervals_is_full_interval_scheduling_bit_for_bit():
    ref, port, _ = both(400, seed=1)
    hw = pt_hw.A64FX_CORE
    costed = pt_cost.cost_program(port, hw, compute_dtype=DT)
    cfg = pt_sample.SamplingConfig(interval_ops=64.0)
    exact = pt_sample.full_interval_estimate(port, hw, 12, config=cfg,
                                             compute_dtype=DT, costed=costed)
    assert exact.plan.k == exact.plan.n_intervals
    assert exact.frac_ops_scheduled == 1.0
    sam = pt_sample.sampled_schedule_node(
        port, hw, 12, config=dataclasses.replace(cfg, k=10 ** 9),
        compute_dtype=DT, costed=costed)
    assert sam.t_est == exact.t_est
    assert np.array_equal(sam.t_rep, exact.t_rep)
    assert sam.port_busy == exact.port_busy
    want = ref_sample.full_interval_estimate(
        ref, ref_hw.A64FX_CORE, 12,
        config=ref_sample.SamplingConfig(interval_ops=64.0),
        compute_dtype=DT)
    assert exact.t_est == want.t_est
    assert np.array_equal(exact.t_rep, want.t_rep)


@pytest.mark.parametrize("n_cores,partition", [(1, "shard"), (12, "shard"),
                                               (48, "shard"),
                                               (12, "round-robin")])
def test_sampled_schedule_node_matches_the_reference(n_cores, partition):
    ref, port, _ = both(300, seed=4, repeats=3)
    kw = dict(config=None, compute_dtype=DT, partition=partition)
    want = ref_sample.sampled_schedule_node(
        ref, ref_hw.A64FX_CORE, n_cores, topology=ref_hw.A64FX_NODE,
        **{**kw, "config": ref_sample.SamplingConfig(interval_ops=90.0)})
    got = pt_sample.sampled_schedule_node(
        port, pt_hw.A64FX_CORE, n_cores, topology=pt_hw.A64FX_NODE,
        **{**kw, "config": pt_sample.SamplingConfig(interval_ops=90.0)})
    for name in ("t_est", "t_zero_contention", "parallel_efficiency",
                 "bound_by", "port_busy", "traffic_by_level", "n_cores",
                 "partition"):
        assert getattr(got, name) == getattr(want, name), name
    assert np.array_equal(got.t_rep, want.t_rep)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_sampled_node_sweep_matches_the_reference(backend):
    """The [C, B] grid over the zoo's 12 combos at 1/12/48 cores, bit for
    bit with the reference's NumPy sweep; ``backend="torch"`` runs the
    port's scan through its plain version on the CPU."""
    ref, port, _ = both(240, seed=5)
    grid = [(w, mw, vw, 16) for w in (16, 64, 256) for mw in (1, 2)
            for vw in (1, 2)]
    cfg = dict(interval_ops=40.0, k=3)
    want, _ = ref_sample.sampled_node_sweep(
        ref, ref_hw.A64FX_CORE,
        ref_compiled.O3Knobs.from_grid(ref_hw.A64FX_CORE, grid), (1, 12, 48),
        topology=ref_hw.A64FX_NODE, config=ref_sample.SamplingConfig(**cfg),
        compute_dtype=DT)
    got, plan = pt_sample.sampled_node_sweep(
        port, pt_hw.A64FX_CORE,
        pt_compiled.O3Knobs.from_grid(pt_hw.A64FX_CORE, grid), (1, 12, 48),
        topology=pt_hw.A64FX_NODE, config=pt_sample.SamplingConfig(**cfg),
        compute_dtype=DT, backend=backend, device="cpu")
    assert plan.k == 3 and got.shape == (3, 12)
    assert np.array_equal(got, want)


def test_sampled_node_sweep_agrees_with_the_scalar_path():
    _, port, inst = both(150, seed=8, repeats=8)
    hw = pt_hw.A64FX_CORE
    costed = pt_cost.cost_program(port, hw, compute_dtype=DT)
    plan = pt_sample.sample_program(
        port, hw, pt_sample.SamplingConfig(interval_ops=inst,
                                           phase_aware=False), DT, costed)
    grid, plan_out = pt_sample.sampled_node_sweep(
        port, hw, pt_compiled.O3Knobs.single(hw), (1, 12, 48),
        compute_dtype=DT, plan=plan)
    assert plan_out is plan and grid.shape == (3, 1)
    for ci, n in enumerate((1, 12, 48)):
        sr = pt_sample.sampled_schedule_node(port, hw, n, compute_dtype=DT,
                                             plan=plan)
        assert grid[ci, 0] == pytest.approx(sr.t_est, rel=1e-9)
    nc = pt_node.compile_node(port, hw, compute_dtype=DT, costed=costed)
    full = pt_node.schedule_node_sweep(nc, hw, pt_compiled.O3Knobs.single(hw),
                                       (1, 12, 48))
    assert np.all(np.abs(grid - full) / full < 0.05)


def test_unroll_program_matches_the_reference():
    step = synthetic_program(120, seed=6)
    want = ref_sample.unroll_program(step, 5)
    got = pt_sample.unroll_program(to_port(step), 5)
    assert [dataclasses.asdict(o) for o in got.ops] \
        == [dataclasses.asdict(o) for o in want.ops]
    assert got.entry == want.entry
    assert pt_sample.unroll_program(got, 1) is got


def test_bench_dag_pin_5pct_error_at_20pct_ops():
    """The reference's acceptance pin on the port: the 10k-op bench DAG
    within 5 % of the monolithic schedule at <= 20 % of the instances,
    the same row as the reference's but for the wall seconds."""
    ref, port, inst = both(250, seed=3, repeats=40)
    cfg = dict(interval_ops=inst, phase_aware=False)
    got = pt_sample.measure_sampled_vs_full(
        port, pt_hw.A64FX_CORE, 48,
        config=pt_sample.SamplingConfig(**cfg), compute_dtype=DT)
    want = ref_sample.measure_sampled_vs_full(
        ref, ref_hw.A64FX_CORE, 48,
        config=ref_sample.SamplingConfig(**cfg), compute_dtype=DT)
    assert len(port.ops) == 10_000
    assert abs(got["reconstruction_error_pct"]) <= 5.0
    assert got["frac_ops_scheduled"] <= 0.20
    walls = {"wall_full_s", "wall_sampled_s", "speedup"}
    assert {k: v for k, v in got.items() if k not in walls} \
        == {k: v for k, v in want.items() if k not in walls}


def test_simulate_sampling_json_matches_the_reference():
    kw = dict(engine="node", n_cores=12, node_partition="shard",
              compute_dtype="f32")
    want = ref_simulate.simulate(
        STUB_HLO, hw=ref_hw.A64FX_CORE,
        sampling=ref_sample.SamplingConfig(interval_ops=1.0), **kw)
    got = pt_simulate.simulate(
        STUB_HLO, hw=pt_hw.A64FX_CORE,
        sampling=pt_sample.SamplingConfig(interval_ops=1.0), **kw)
    assert got.sampled is not None and got.node is None
    assert got.t_est == got.sampled.t_est == want.t_est
    assert math.isfinite(got.t_est) and got.t_est > 0
    g, w = json.loads(got.to_json()), json.loads(want.to_json())
    assert set(g) == set(w) and set(g["sampled"]) == set(w["sampled"])
    assert g["sampled"] == w["sampled"]
    assert 0 < g["sampled"]["frac_ops_scheduled"] <= 1.0


def _aten_program():
    def f(x, w):
        for _ in range(4):
            x = torch.tanh(x @ w) + x
        return x.float().sum()
    prog = aten.parse_graph(aten.capture(
        f, torch.randn(64, 64, dtype=torch.bfloat16),
        torch.randn(64, 64, dtype=torch.bfloat16)))
    assert prog.exact_dtypes
    return prog


def test_an_aten_capture_has_no_phase_boundaries():
    """Eager ATen is unrolled, every op of count 1: no cut where the count
    changes, so the cuts fall by instance count alone."""
    prog = _aten_program()
    assert {o.count for o in prog.ops} == {1.0}
    assert pt_sample.phase_boundaries(prog).size == 0
    ivs = pt_sample.slice_intervals(prog, 4.0, phase_aware=True)
    assert [iv.n_instances for iv in ivs[:-1]] == [4.0] * (len(ivs) - 1)


def test_slices_and_unrolled_traces_keep_exact_dtypes():
    """A capture's intervals and unrolled copies cost at its real dtypes:
    the slices' costs equal the whole program's, op for op."""
    prog = _aten_program()
    long = pt_sample.unroll_program(prog, 3)
    assert long.exact_dtypes
    hw = pt_hw.H100
    whole = pt_cost.cost_program(prog, hw, compute_dtype="bf16")
    again = pt_cost.cost_program(long, hw, compute_dtype="bf16")[:len(whole)]
    assert [o.t_op if o else None for o in again] \
        == [o.t_op if o else None for o in whole]
    plan = pt_sample.sample_program(
        long, hw, pt_sample.SamplingConfig(interval_ops=len(prog.ops),
                                           phase_aware=False), "bf16")
    assert plan.k == 1 and all(p.exact_dtypes for p in plan.rep_programs)


def test_a_spec_without_mem_levels_samples():
    """The port names the feature levels by ``memory_hierarchy()``: on a
    spec with only boundary scalars the reference's ``mem_levels`` lookup
    raises, the port's sampled estimate at k >= n_intervals is full
    interval scheduling, and on a spec with levels both agree (above)."""
    ref, port, _ = both(200, seed=9)
    cfg = dict(interval_ops=50.0)
    with pytest.raises(KeyError):
        ref_sample.sample_program(ref, ref_hw.TPU_V5E,
                                  ref_sample.SamplingConfig(**cfg), "bf16")
    for hw in (pt_hw.TPU_V5E, pt_hw.H100, pt_hw.CPU_HOST):
        assert not hw.mem_levels
        exact = pt_sample.full_interval_estimate(
            port, hw, 1, config=pt_sample.SamplingConfig(**cfg),
            compute_dtype="bf16")
        assert exact.plan.n_intervals == 7          # 338 instances / 50
        assert set(exact.traffic_by_level) == {"vmem", "hbm"}
        assert math.isfinite(exact.t_est) and exact.t_est > 0

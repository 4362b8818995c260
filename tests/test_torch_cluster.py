"""``repro_torch.core.cluster`` against ``repro.core.cluster``, bit for bit.

The reference's synthetic workloads (``tests/test_cluster.py``: the
perf-smoke DAG at 24-48 ops, a "hot" workload with heavy payloads, an MoE
workload whose tensor axis goes to expert parallelism) go through both
packages as the same ``OpStat`` lists.  Held equal: the per-node programs
and their collective sites, every ``schedule_cluster`` row and every
``cluster_sweep`` result, field for field.
"""
import dataclasses
import math

import numpy as np
import pytest

from benchmarks.sched_throughput import synthetic_program
from repro.core import cluster as ref_cluster
from repro.core import hwspec as ref_hw
from repro_torch.core import cluster as pt_cluster
from repro_torch.core import hlo as pt_hlo
from repro_torch.core import hwspec as pt_hw
from repro_torch.core.node import compile_node, schedule_node


def to_port(prog):
    return pt_hlo.Program(
        ops=[pt_hlo.OpStat(**dataclasses.asdict(o)) for o in prog.ops],
        entry=prog.entry, n_partitions=prog.n_partitions)


WORKLOADS = {   # name -> (ops, ClusterWorkload fields beside the program)
    "base": (40, dict(repeats=8, layers=2, d_model=256, seq_len=64,
                      batch=2, param_bytes=1e8, frac_attn=0.4,
                      moe_top_k=2)),
    "hot": (24, dict(repeats=8, layers=4, d_model=4096, seq_len=512,
                     batch=8, param_bytes=5e10, frac_attn=0.4)),
    "moe": (32, dict(repeats=4, layers=2, d_model=1024, seq_len=128,
                     batch=4, param_bytes=2e9, frac_attn=0.3,
                     moe_top_k=2)),
}


def workloads(name):
    n, kw = WORKLOADS[name]
    prog = synthetic_program(n, seed=3)
    return (ref_cluster.ClusterWorkload(name=name, prog=prog, **kw),
            pt_cluster.ClusterWorkload(name=name, prog=to_port(prog), **kw))


def experts(pkg):
    """A resolver that gives the tensor axis to the experts above tp 2."""
    def resolve(tp):
        return pkg.ShardDecision(attn=True, mlp=tp <= 2, experts=tp > 2)
    return resolve


def as_plain(x):
    """Dataclasses as tuples of plain values, so the two packages' equal
    records compare equal."""
    if dataclasses.is_dataclass(x):
        return tuple(as_plain(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {k: as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(as_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return tuple(x.tolist())
    return x


@pytest.mark.parametrize("tp,pp", [(1, 1), (4, 2), (2, 4), (8, 1)])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_make_cluster_program_matches_the_reference(name, tp, pp):
    ref_w, pt_w = workloads(name)
    want, want_sites = ref_cluster.make_cluster_program(
        ref_w, tp, pp, experts(ref_cluster)(tp))
    got, got_sites = pt_cluster.make_cluster_program(
        pt_w, tp, pp, experts(pt_cluster)(tp))
    assert [dataclasses.asdict(o) for o in got.ops] \
        == [dataclasses.asdict(o) for o in want.ops]
    assert as_plain(got_sites) == as_plain(want_sites)
    assert got.entry == want.entry


def test_a_stage_needs_a_trace_copy_in_both():
    ref_w, pt_w = workloads("moe")
    for pkg, w in ((ref_cluster, ref_w), (pt_cluster, pt_w)):
        with pytest.raises(ValueError, match="exceeds"):
            pkg.make_cluster_program(w, 1, 8)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_cluster_sweep_matches_the_reference(name):
    ref_w, pt_w = workloads(name)
    kw = dict(n_cores=12, max_tp=4, max_pp=2)
    want = ref_cluster.cluster_sweep(ref_w, (2, 8, 16),
                                     resolver=experts(ref_cluster), **kw)
    got = pt_cluster.cluster_sweep(pt_w, (2, 8, 16),
                                   resolver=experts(pt_cluster), **kw)
    assert len(got) == len(want) > 0
    assert as_plain(got) == as_plain(want)
    for r in got:
        assert 0.0 < r.t_floor_s <= r.t_step_s < math.inf
        assert 0.0 < r.parallel_efficiency <= 1.0 + 1e-9


def test_heavy_payloads_engage_the_link_fixpoint():
    _, pt_w = workloads("hot")
    res = pt_cluster.cluster_sweep(pt_w, (16,), n_cores=1, max_tp=4,
                                   max_pp=2)
    assert any(r.ici_n_active > 1.0 for r in res if r.plan.tp > 1)


@pytest.mark.parametrize("n_cores,topo", [(1, None), (48, "degenerate")])
def test_schedule_cluster_matches_the_reference(n_cores, topo):
    """Every row, the per-site link times included, on cells of several
    node counts (the default A64FX node topology, or a degenerate one)."""
    ref_w, pt_w = workloads("base")
    rows = []
    for pkg, hw, w in ((ref_cluster, ref_hw, ref_w),
                       (pt_cluster, pt_hw, pt_w)):
        prog, sites = pkg.make_cluster_program(w, 2, 2)
        cells = [(pkg.ParallelPlan(dp=n // 4, tp=2, pp=2),
                  hw.ClusterTopology.tofu_d(n)) for n in (4, 16, 64)]
        rows.append(pkg.schedule_cluster(
            prog, sites, cells, hw=hw.A64FX_CORE, n_cores=n_cores,
            topology=(hw.NodeTopology.degenerate(48) if topo else None)))
    got, want = rows
    for g, w in zip(got, want):
        assert as_plain(g["plan"]) == as_plain(w["plan"])
        assert g["cluster"].name == w["cluster"].name
        for key in ("hops", "t_sched", "t_floor", "ici_n_active",
                    "iterations"):
            assert g[key] == w[key], key
        assert np.array_equal(g["t_ici"], w["t_ici"])


def test_geometry_and_pricing_match_the_reference():
    assert pt_cluster.plan_shapes(16, 8) == ref_cluster.plan_shapes(16, 8)
    for n in (2, 8, 64, 1024):
        rc, pc = ref_hw.ClusterTopology.tofu_d(n), \
            pt_hw.ClusterTopology.tofu_d(n)
        for plan in ((n // 4, 2, 2), (1, n, 1), (n, 1, 1)):
            if plan[1] * plan[2] > n:
                continue
            assert pt_cluster.axis_hops(pc, pt_cluster.ParallelPlan(*plan)) \
                == ref_cluster.axis_hops(rc, ref_cluster.ParallelPlan(*plan))
        for kind in ("all-reduce", "all-to-all", "collective-permute"):
            for g, payload, act in ((2, 1.5e6, 1.0), (8, 3e7, 2.5),
                                    (1, 0.0, 1.0)):
                assert pt_cluster.collective_time(
                    kind, g, payload, pc, hops=1.5, n_active=act) \
                    == ref_cluster.collective_time(
                        kind, g, payload, rc, hops=1.5, n_active=act)


def test_two_node_cluster_is_the_node_engine_plus_one_collective():
    """The reference's degenerate differential on the port: a 2-node DP
    cluster whose one collective hangs off the tail costs exactly a node
    run of the base program plus the canonical link time."""
    base = to_port(synthetic_program(48, seed=3))
    ops, sites = pt_cluster._inject(
        list(base.ops), [(1.0, pt_cluster._coll("tail_ar", "all-reduce",
                                                1.5e6, 1.0), False, "dp")])
    prog = pt_hlo.Program(ops=ops, entry="deg", n_partitions=1)
    cl = pt_hw.ClusterTopology.tofu_d(2)
    plan = pt_cluster.ParallelPlan(dp=2, tp=1, pp=1)
    row, = pt_cluster.schedule_cluster(prog, sites, [(plan, cl)],
                                       hw=pt_hw.A64FX_CORE, n_cores=1)
    nr = schedule_node(compile_node(base, pt_hw.A64FX_CORE),
                       pt_hw.A64FX_CORE, 1, partition="shard")
    dur = pt_cluster.collective_time(
        "all-reduce", 2, 1.5e6, cl, hops=pt_cluster.axis_hops(cl, plan)["dp"],
        n_active=1.0) + pt_hw.A64FX_CORE.op_startup_ns * 1e-9
    assert row["t_sched"] == max(nr.t_est, float(nr.finishes[-1]) + dur)
    assert row["t_floor"] == nr.t_est


def test_cluster_programs_keep_exact_dtypes():
    _, pt_w = workloads("base")
    pt_w.prog.exact_dtypes = True
    prog, _ = pt_cluster.make_cluster_program(pt_w, 2, 1)
    assert prog.exact_dtypes

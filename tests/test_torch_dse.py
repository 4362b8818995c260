"""``repro_torch.core.dse`` against ``repro.core.dse``.

Field for field on the candidate grid (names, flops tables, memory levels,
topologies) and on ``pareto_front``; bit for bit on ``sweep_workload`` of a
shared 400-op program, on NumPy and on the port's scan through its plain
version, and on ``run_dse``'s payload with both packages' ``trace_phase``
monkeypatched to return the same programs.  The port's fused sweep is also
held against its own per-spec loop on the whole 64-point grid, whose
candidates mix 8-72 cores, 1-6 CMGs and a ring latency of 0 and 130 ns.
"""
import dataclasses

import numpy as np
import pytest
import torch

from benchmarks.sched_throughput import synthetic_program
from repro.core import dse as ref_dse
from repro.core import zoo as ref_zoo
from repro_torch.core import dse
from repro_torch.core import hlo as pt_hlo
from repro_torch.core import zoo
from repro_torch.core.compiled import O3Knobs
from repro_torch.core.node import (compile_node, compile_node_grid,
                                   schedule_node_batch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shared(n=400, seed=2):
    """One synthetic DAG as the reference's ``Program`` and the port's."""
    prog = synthetic_program(n, seed=seed)
    return prog, pt_hlo.Program(
        ops=[pt_hlo.OpStat(**dataclasses.asdict(o)) for o in prog.ops],
        entry=prog.entry, n_partitions=prog.n_partitions)


def test_the_grid_is_the_references():
    got, want = dse.generate_grid(), ref_dse.generate_grid()
    assert len(got) == len(want) == 64
    assert [dataclasses.astuple(p) for p in got] \
        == [dataclasses.astuple(p) for p in want]
    assert [(p.name, p.n_cores) for p in got] \
        == [(p.name, p.n_cores) for p in want]
    assert len({p.name for p in got}) == 64
    assert dse.SpecPoint(4, 12, 1, 130.0, 2) in got      # A64FX
    assert dse.DSE_SCHEMA == ref_dse.DSE_SCHEMA


@pytest.mark.parametrize("part", range(4))
def test_materialize_matches_the_reference(part):
    """Every candidate's spec, field for field: name, peak and VPU flops,
    the three memory levels (shared by the CMG's cores), HBM capacity and
    the node topology with its ring."""
    for p in dse.generate_grid()[part::4]:
        rp = ref_dse.SpecPoint(*dataclasses.astuple(p))
        got, want = dse.materialize(p), ref_dse.materialize(rp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert [lv.name for lv in got.memory_hierarchy()] \
            == [lv.name for lv in want.memory_hierarchy()] \
            == ["l1d", "l2", "hbm2"]
        assert got.topology.n_cores == p.n_cores


def test_spec_grid_matches_the_reference():
    pts = dse.generate_grid()
    got = dse.spec_grid(pts)
    want = ref_dse.spec_grid(ref_dse.generate_grid())
    assert got.S == want.S == 64
    assert got.level_names == want.level_names
    for s in range(got.S):
        assert dataclasses.asdict(got.specs[s]) \
            == dataclasses.asdict(want.specs[s])
        assert dataclasses.asdict(got.topology_of(s)) \
            == dataclasses.asdict(want.topology_of(s))


@pytest.mark.parametrize("seed", range(6))
def test_pareto_front_matches_the_reference(seed):
    """Seeded [N, 3] costs drawn from a few values, so rows tie on some
    axes and some rows repeat."""
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 7, 40):
        costs = rng.integers(0, 4, size=(n, 3)).astype(float)
        got = dse.pareto_front(costs)
        assert got == ref_dse.pareto_front(costs)
        assert got == sorted(got)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_sweep_workload_matches_the_reference(backend):
    ref, port = shared()
    want = ref_dse.sweep_workload(ref, ref_dse.spec_grid(
        ref_dse.generate_grid()))
    got = dse.sweep_workload(port, dse.spec_grid(dse.generate_grid()),
                             backend=backend, device="cpu")
    assert set(got) == set(want) == {"t_est", "hbm_bytes", "n_cores"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    assert np.isfinite(got["t_est"]).all() and (got["t_est"] > 0).all()


def test_the_fused_sweep_on_the_scan_equals_the_per_spec_loop():
    """``tools/dse_sweep_torch.py``'s bit-identity check on the DSE grid
    itself: every candidate's shard pass at its full core count, through
    the scan's plain version, against ``compile_node`` +
    ``schedule_node_batch`` per candidate on NumPy."""
    _, prog = shared(n=150, seed=5)
    grid = dse.spec_grid(dse.generate_grid())
    got = dse.sweep_workload(prog, grid, backend="torch",
                             device="cpu")["t_est"]
    for s, sp in enumerate(grid.specs):
        topo = grid.topology_of(s)
        nc = compile_node(prog, sp, compute_dtype="f32")
        res = schedule_node_batch(nc, sp, O3Knobs.single(sp), topo.n_cores,
                                  topology=topo, partition="shard")
        assert res.t_est[0] == got[s], grid.specs[s].name
    # the outermost level, whose bytes are the HBM axis, is HBM2
    assert compile_node_grid(prog, grid, compute_dtype="f32") \
        .grid.level_names[-1] == "hbm2"


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_run_dse_matches_the_reference(monkeypatch, backend):
    """Three workloads (different DAGs) through both packages' ``run_dse``
    on a 16-point grid: the whole payload equal, estimates, Pareto fronts,
    best specs and the Kendall-tau matrix included."""
    cells = [("a", "prefill"), ("b", "decode"), ("c", "train")]
    progs = {c: shared(n=120, seed=10 + i) for i, c in enumerate(cells)}

    def fake(which):
        def trace(arch, phase, shape=None, param_dtype="float32",
                  hlo_cache_dir=None):
            return progs[(arch, phase)][which]
        return trace

    monkeypatch.setattr(ref_zoo, "trace_phase", fake(0))
    monkeypatch.setattr(zoo, "trace_phase", fake(1))
    axes = dict(n_cmgs=(1, 4), cores_per_cmg=(8, 12), hbm_stacks=(1, 2),
                ring_latency_ns=(0.0, 130.0), vpu_lanes=(2,))
    want = ref_dse.run_dse(cells, points=ref_dse.generate_grid(**axes))
    got = dse.run_dse(cells, points=dse.generate_grid(**axes),
                      backend=backend, device="cpu")
    assert got == want
    assert got["n_specs"] == 16 and len(got["per_workload"]) == 3
    assert np.array(got["rank_stability"]["tau_matrix"]).shape == (3, 3)

"""The port's batched schedulers equal the reference's NumPy paths, bit for
bit, with ``backend="numpy"`` and with ``backend="torch", device="cpu"``.

``schedule_batch``, ``schedule_node_batch``, ``schedule_node_sweep``,
``compile_node_grid`` + ``schedule_spec_sweep`` and ``sweep_o3`` at core
counts above 1 against ``repro.core.compiled``/``repro.core.node`` on the
same random DAGs (``tests/_sched_dags.py``) under ``A64FX_CORE`` +
``A64FX_NODE``; ``backend="torch"`` on the CPU runs the scan's plain version
(``kernels.sched_scan.node_scan_plain``) in every pass of the fixpoint.
The kernel's own indexing (ring sizes, explicit window tests, staging in
chunks) is replayed in Python by ``tests/_sched_scan_emu.py`` and held to
the NumPy pass too.  Edge cases: no ops, no batch elements, window 1,
width 4, depth 64.  The reference's ``sweep_o3`` does not import here
(``repro.core.calibrate`` fails under jax 0.9), so its rows are rebuilt
from the reference's ``schedule_batch`` and ``schedule_node_sweep``
called directly, over calibrate's grid rebuilt from its constants.
"""

import numpy as np
import pytest
import torch
from _sched_dags import both_programs
from _sched_scan_emu import emulate

from repro.core import compiled as ref_compiled
from repro.core import hlo as ref_hlo
from repro.core import hwspec as ref_hw
from repro.core import node as ref_node
from repro_torch.core import calibrate as cal
from repro_torch.core import compiled as pt_compiled
from repro_torch.core import hlo as pt_hlo
from repro_torch.core import hwspec as pt_hw
from repro_torch.core import node as pt_node
from repro_torch.kernels import sched_scan

torch.set_num_threads(1)

BACKENDS = [("numpy", "cuda"), ("torch", "cpu")]
COMBOS = [(w, mw, vw, qd) for w in cal.O3_WINDOWS for mw in cal.O3_MEM_WIDTHS
          for vw in cal.O3_VPU_WIDTHS for qd in cal.O3_QUEUE_DEPTHS]
# a small grid with the edges: window 1, width 4, depth 64, clamped rows
EDGE_COMBOS = [(1, 4, 1, 64), (0, 4, 2, 1), (2, 1, 1, 64), (1024, 4, 2, 64),
               (1, 4, 1, 64), (7, 3, 2, 5)]


def knobs_pair(hw_name, combos):
    return (ref_compiled.O3Knobs.from_grid(getattr(ref_hw, hw_name), combos),
            pt_compiled.O3Knobs.from_grid(getattr(pt_hw, hw_name), combos))


def assert_batch_equal(got, want):
    for f in ("t_est", "t_zero_contention", "iterations"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.scheduled_passes == want.scheduled_passes
    assert got.total_scheduled_ops == want.total_scheduled_ops


@pytest.mark.parametrize("backend,device", BACKENDS)
@pytest.mark.parametrize("seed,n", [(0, 120), (1, 1), (2, 0)])
def test_schedule_batch_equals_the_reference(seed, n, backend, device):
    ref_prog, pt_prog = both_programs(seed, n, ref_hlo, pt_hlo)
    for hw_name in ("CPU_HOST", "A64FX_CORE"):
        for combos in (COMBOS, EDGE_COMBOS, []):
            kr, kp = knobs_pair(hw_name, combos)
            want = ref_compiled.schedule_batch(
                ref_compiled.compile_program(ref_prog,
                                             getattr(ref_hw, hw_name)), kr)
            got = pt_compiled.schedule_batch(
                pt_compiled.compile_program(pt_prog,
                                            getattr(pt_hw, hw_name)), kp,
                backend, device)
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("backend,device", BACKENDS)
@pytest.mark.parametrize("n_cores,partition", [
    (1, "shard"), (12, "shard"), (48, "shard"), (4, "round-robin"),
    (48, "round-robin"), (12, "graph"), (48, "graph")])
def test_schedule_node_batch_equals_the_reference(n_cores, partition,
                                                  backend, device):
    ref_prog, pt_prog = both_programs(n_cores, 150, ref_hlo, pt_hlo)
    kr, kp = knobs_pair("A64FX_CORE", COMBOS[::3] + EDGE_COMBOS)
    want = ref_node.schedule_node_batch(
        ref_node.compile_node(ref_prog, ref_hw.A64FX_CORE),
        ref_hw.A64FX_CORE, kr, n_cores, ref_hw.A64FX_NODE, partition)
    got = pt_node.schedule_node_batch(
        pt_node.compile_node(pt_prog, pt_hw.A64FX_CORE), pt_hw.A64FX_CORE,
        kp, n_cores, pt_hw.A64FX_NODE, partition, backend=backend,
        device=device)
    assert_batch_equal(got, want)
    assert got.scheduled_passes is not None      # the clamped rows deduped


@pytest.mark.parametrize("backend,device", BACKENDS)
@pytest.mark.parametrize("partition,counts", [
    ("shard", (1, 4, 12, 48)), ("round-robin", (4, 48)), ("graph", (12,))])
def test_schedule_node_sweep_equals_the_reference(partition, counts,
                                                  backend, device):
    ref_prog, pt_prog = both_programs(11, 120, ref_hlo, pt_hlo)
    kr, kp = knobs_pair("A64FX_CORE", COMBOS[::5] + EDGE_COMBOS)
    want = ref_node.schedule_node_sweep(
        ref_node.compile_node(ref_prog, ref_hw.A64FX_CORE, compute_dtype="f64"),
        ref_hw.A64FX_CORE, kr, counts, ref_hw.A64FX_NODE, partition)
    got = pt_node.schedule_node_sweep(
        pt_node.compile_node(pt_prog, pt_hw.A64FX_CORE, compute_dtype="f64"),
        pt_hw.A64FX_CORE, kp, counts, pt_hw.A64FX_NODE, partition,
        backend=backend, device=device)
    assert got.shape == (len(counts), kp.batch) and np.array_equal(got, want)


def _grids():
    def build(hw):
        specs = [hw.A64FX_CORE, hw.A64FX_CORE.with_(
            name="slow_hbm", hbm_read_bw=16e9, op_startup_ns=80.0),
            hw.A64FX_CORE.with_(name="fast", hbm_read_bw=128e9,
                                vmem_bw=460e9)]
        small = hw.NodeTopology(
            name="one_cmg", n_cmgs=1, cores_per_cmg=12,
            shared_read_bw={"l2": 450e9, "hbm2": 128e9},
            shared_write_bw={"l2": 225e9, "hbm2": 128e9},
            ring_latency_s=0.0, ring_bw=0.0)
        return hw.SpecGrid(specs, topologies=[hw.A64FX_NODE, small,
                                              hw.A64FX_NODE])
    return build(ref_hw), build(pt_hw)


@pytest.mark.parametrize("backend,device", BACKENDS)
@pytest.mark.parametrize("core_counts", [None, (1, 12), [(1, 4), (4, 12),
                                                          (12, 48)]])
def test_spec_sweep_equals_the_reference(core_counts, backend, device):
    ref_prog, pt_prog = both_programs(21, 100, ref_hlo, pt_hlo)
    gr, gp = _grids()
    ngr = ref_node.compile_node_grid(ref_prog, gr)
    ngp = pt_node.compile_node_grid(pt_prog, gp)
    assert np.array_equal(ngp.durations0, ngr.durations0)
    for vr, vp in zip(ngr.views, ngp.views):
        for f in ("t_comp", "t_ici", "lat", "count", "rd", "wr",
                  "core_read_bw", "core_write_bw", "shared_by"):
            assert np.array_equal(getattr(vp, f), getattr(vr, f)), f
    kr, kp = knobs_pair("A64FX_CORE", COMBOS[::7] + EDGE_COMBOS)
    want = ref_node.schedule_spec_sweep(ngr, kr, core_counts)
    got = pt_node.schedule_spec_sweep(ngp, kp, core_counts, backend=backend,
                                      device=device)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_empty_programs_and_batches():
    """n = 0 and M = 0 return zeros on both backends, and the torch
    backend's scan is never reached for them."""
    _, prog = both_programs(0, 0, ref_hlo, pt_hlo)
    _, full = both_programs(0, 30, ref_hlo, pt_hlo)
    empty_knobs = pt_compiled.O3Knobs.from_grid(pt_hw.A64FX_CORE, [])
    knobs = pt_compiled.O3Knobs.from_grid(pt_hw.A64FX_CORE, EDGE_COMBOS)
    before = sched_scan.node_scan.elements
    for p, k in ((prog, knobs), (full, empty_knobs), (prog, empty_knobs)):
        for backend, device in BACKENDS:
            t = pt_compiled.schedule_batch(
                pt_compiled.compile_program(p, pt_hw.A64FX_CORE), k,
                backend, device)
            assert t.shape == (k.batch,) and not t.any()
            r = pt_node.schedule_node_batch(
                pt_node.compile_node(p, pt_hw.A64FX_CORE), pt_hw.A64FX_CORE,
                k, 48, pt_hw.A64FX_NODE, "round-robin", backend=backend,
                device=device)
            assert r.t_est.shape == (k.batch,) and not r.t_est.any()
    assert sched_scan.node_scan.elements == before


@pytest.mark.parametrize("n_cores,partition", [(1, "shard"), (4, "round-robin"),
                                               (48, "round-robin"),
                                               (48, "graph")])
def test_kernel_indexing_replayed_equals_the_numpy_pass(n_cores, partition):
    """The CUDA kernel's design, replayed in Python: rings of min(window,
    ops on the stream) slots with explicit window tests, one lane count for
    every port, ops and edges staged in chunks (also tiny ones, so that an
    op with more edges than a chunk holds is read directly)."""
    _, prog = both_programs(40 + n_cores, 90, ref_hlo, pt_hlo)
    nc = pt_node.compile_node(prog, pt_hw.A64FX_CORE)
    nb = pt_node.compile_node_batch(nc, pt_hw.A64FX_CORE, n_cores,
                                    pt_hw.A64FX_NODE, partition)
    knobs = pt_compiled.O3Knobs.from_grid(pt_hw.A64FX_CORE,
                                          COMBOS[::4] + EDGE_COMBOS)
    rng = np.random.default_rng(n_cores)
    durs = nc.cp.durations[:, None] * rng.uniform(0.5, 2.0, (1, knobs.batch))
    want = pt_node._node_pass_batch(nb, durs, knobs.window, knobs.width,
                                    knobs.depth)
    st = pt_node.scan_structure(nb, "cpu")
    assert (st.edge_extra is not None) == (n_cores == 48)
    for chunk, edges in ((64, 1024), (5, 3), (1, 1)):
        got = emulate(st, durs, knobs.window, knobs.width, knobs.depth,
                      chunk, edges)
        assert np.array_equal(got, want), (chunk, edges)
    plain = sched_scan.node_scan(st, torch.from_numpy(durs),
                                 *sched_scan.knob_tensors(
                                     knobs.window, knobs.width, knobs.depth,
                                     "cpu"))
    assert np.array_equal(plain.numpy(), want)


@pytest.fixture
def sweep_table():
    """An accuracy table of three small programs with made-up measured
    times (the sweep re-schedules, it does not measure)."""
    progs = [both_programs(s, n, ref_hlo, pt_hlo)
             for s, n in ((31, 60), (32, 25), (33, 80))]
    rows = [cal.KernelRow(f"k{i}", "made-up", 1, measured_us=m,
                          simulated_us=m)
            for i, m in enumerate((40.0, 900.0, 7.5))]
    return progs, cal.AccuracyTable(rows, [p for _, p in progs])


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_sweep_o3_over_core_counts_equals_the_reference(sweep_table, backend,
                                                        device):
    """Every row of ``sweep_o3(core_counts=(1, 4, 12))`` is the reference's
    ``schedule_batch`` (1 core) and ``schedule_node_sweep`` (4 and 12,
    shard) of each program against its made-up time; best among 1 core."""
    progs, table = sweep_table
    counts = (1, 4, 12)
    sweep = cal.sweep_o3(table, pt_hw.A64FX_CORE, core_counts=counts,
                         backend=backend, device=device)
    knobs = ref_compiled.O3Knobs.from_grid(ref_hw.A64FX_CORE, COMBOS)
    diffs = np.empty((len(progs), len(counts), knobs.batch))
    for r, ((ref_prog, _), row) in enumerate(zip(progs, table.rows)):
        t = {1: ref_compiled.schedule_batch(ref_compiled.compile_program(
            ref_prog, ref_hw.A64FX_CORE, compute_dtype="f64"), knobs)}
        t.update(zip((4, 12), ref_node.schedule_node_sweep(
            ref_node.compile_node(ref_prog, ref_hw.A64FX_CORE,
                                  compute_dtype="f64"),
            ref_hw.A64FX_CORE, knobs, (4, 12), None, partition="shard")))
        for ci, k in enumerate(counts):
            diffs[r, ci] = np.abs(t[k] * 1e6 - row.measured_us) \
                / row.measured_us * 100.0
    want = {(k, *c): (float(m), float(w)) for ci, k in enumerate(counts)
            for c, m, w in zip(COMBOS, diffs.mean(axis=0)[ci],
                               (diffs <= 10.0).mean(axis=0)[ci])}
    assert len(sweep.results) == len(want)
    for r in sweep.results:
        key = (r["n_cores"], r["inflight_window"], r["mem_issue_width"],
               r["vpu_issue_width"], r["queue_depth"])
        assert (r["mean_abs_diff_pct"], r["within_10pct"]) == want[key]
    means = [r["mean_abs_diff_pct"] for r in sweep.results]
    assert means == sorted(means)
    best = next(r for r in sweep.results if r["n_cores"] == 1)
    assert sweep.best.inflight_window == best["inflight_window"]
    assert sweep.best.issue_width["mem"] == best["mem_issue_width"]


def test_backends_that_are_not_the_port_s_raise(monkeypatch):
    _, prog = both_programs(5, 20, ref_hlo, pt_hlo)
    cp = pt_compiled.compile_program(prog, pt_hw.A64FX_CORE)
    nc = pt_node.compile_node(prog, pt_hw.A64FX_CORE)
    knobs = pt_compiled.O3Knobs.from_grid(pt_hw.A64FX_CORE, EDGE_COMBOS)
    calls = [lambda **kw: pt_compiled.schedule_batch(cp, knobs, **kw),
             lambda **kw: pt_node.schedule_node_batch(
                 nc, pt_hw.A64FX_CORE, knobs, 4, **kw),
             lambda **kw: pt_node.schedule_node_sweep(
                 nc, pt_hw.A64FX_CORE, knobs, (4, 12), **kw)]
    for call in calls:
        with pytest.raises(ValueError, match="torch"):
            call(backend="jax")
        with pytest.raises(ValueError, match="unknown"):
            call(backend="cupy")
        with pytest.raises(ValueError, match="unsupported device"):
            call(backend="torch", device="meta")
    # without a card, the default device raises: no fallback to NumPy or
    # to the plain version
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = sched_scan.node_scan.elements
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_compiled.schedule_batch(
            cp, pt_compiled.O3Knobs.from_grid(pt_hw.A64FX_CORE, []),
            backend="torch")
    assert sched_scan.node_scan.elements == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        sched_scan.node_scan(
            pt_node.scan_structure(pt_node.compile_node_batch(
                nc, pt_hw.A64FX_CORE, 4, pt_hw.A64FX_NODE, "round-robin"),
                "meta"),
            torch.zeros((nc.n, 1), dtype=torch.float64, device="meta"),
            *sched_scan.knob_tensors([1], [[1] * 4], [[1] * 4], "meta"))

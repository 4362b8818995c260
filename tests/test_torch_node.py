"""The port's node engine is the reference's, bit for bit.

The same programs go through ``repro.core.node`` and ``repro_torch.core.node``
(random DAGs from ``tests/_sched_dags.py``, the reference's ``CHAIN_HLO`` and
``INDEP_HLO``, a memory-bound stream), under ``A64FX_CORE`` +
``A64FX_NODE`` at 1, 4, 12 and 48 cores: the compiled node form, both
op partitions, ``schedule_node`` / ``simulate_node`` with every field of
its ``NodeResult``, ``shard_costed`` and ``simulate(engine="node")`` (its
JSON and PA text) must be equal (``==``, no tolerance).  The port is also
held to the reference harness's invariants: the sandwich
``t_zero_contention <= t_est <= t_serial`` above the dataflow bound, and one
core under a degenerate topology equal to ``schedule_arrays``.
"""
import dataclasses
import json
import random

import numpy as np
import pytest
import torch
from _sched_dags import both_programs, random_knobs, random_program

from repro.core import compiled as ref_compiled
from repro.core import hlo as ref_hlo
from repro.core import hwspec as ref_hw
from repro.core import node as ref_node
from repro.core import simulate as ref_simulate
from repro_torch.core import compiled as pt_compiled
from repro_torch.core import hlo as pt_hlo
from repro_torch.core import hwspec as pt_hw
from repro_torch.core import node as pt_node
from repro_torch.core import simulate as pt_simulate
from tests.test_schedule_engine import CHAIN_HLO, INDEP_HLO

torch.set_num_threads(1)

CORES = (1, 4, 12, 48)
PARTITIONS = ("round-robin", "graph", "shard")


def mem_bound_pair(n_ops=24, nbytes=64 * 2**20):
    """The reference harness's Triad-like stream, in both packages: where
    bandwidth contention is the whole story."""
    def build(hlo):
        return hlo.Program(ops=[hlo.OpStat(
            f"cp{i}", "copy", "data", "f64", bytes_accessed=nbytes,
            read_bytes=0.75 * nbytes, write_bytes=0.25 * nbytes)
            for i in range(n_ops)], entry="e", n_partitions=1)
    return build(ref_hlo), build(pt_hlo)


def programs():
    """(name, reference Program, port Program)."""
    out = [(f"dag{seed}", *both_programs(seed, n, ref_hlo, pt_hlo))
           for seed, n in ((0, 40), (1, 97), (2, 1), (3, 0))]
    out += [(name, ref_hlo.parse_program(t), pt_hlo.parse_program(t))
            for name, t in (("chain", CHAIN_HLO), ("indep", INDEP_HLO))]
    out.append(("mem", *mem_bound_pair()))
    return out


PROGRAMS = programs()


def _plain(x):
    """A NodeResult or its parts as comparable Python values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def assert_node_equal(got, want):
    g, w = _plain(got), _plain(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k] == w[k], k


@pytest.mark.parametrize("name,ref_prog,pt_prog", PROGRAMS,
                         ids=[p[0] for p in PROGRAMS])
def test_compile_node_and_partitions_equal_the_reference(name, ref_prog,
                                                         pt_prog):
    ncr = ref_node.compile_node(ref_prog, ref_hw.A64FX_CORE)
    ncp = pt_node.compile_node(pt_prog, pt_hw.A64FX_CORE)
    for f in ("t_comp", "t_ici", "lat", "count", "rd", "wr", "core_read_bw",
              "core_write_bw", "shared_by", "costed_mask"):
        a, b = getattr(ncp, f), getattr(ncr, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (ncp.n, ncp.level_names, ncp.startup) \
        == (ncr.n, ncr.level_names, ncr.startup)
    assert pt_node.compile_node(pt_prog, pt_hw.A64FX_CORE) is ncp  # memoized
    for k in CORES:
        assert np.array_equal(pt_node.partition_round_robin(ncp.n, k),
                              ref_node.partition_round_robin(ncr.n, k))
        assert np.array_equal(pt_node.partition_graph(ncp, k),
                              ref_node.partition_graph(ncr, k))
    assert pt_node.effective_bandwidth(64e9, 256e9, 7.5) \
        == ref_node.effective_bandwidth(64e9, 256e9, 7.5)


@pytest.mark.parametrize("n_cores", CORES)
@pytest.mark.parametrize("name,ref_prog,pt_prog", PROGRAMS,
                         ids=[p[0] for p in PROGRAMS])
def test_schedule_node_equals_the_reference(name, ref_prog, pt_prog,
                                            n_cores):
    """Every field of the NodeResult, every partition, under the A64FX
    node; and the reference harness's sandwich on the port's results."""
    for part in PARTITIONS:
        want = ref_node.simulate_node(ref_prog, ref_hw.A64FX_CORE, n_cores,
                                      ref_hw.A64FX_NODE, part,
                                      compute_dtype="f64")
        got = pt_node.simulate_node(pt_prog, pt_hw.A64FX_CORE, n_cores,
                                    pt_hw.A64FX_NODE, part,
                                    compute_dtype="f64")
        assert_node_equal(got, want)
        s = got.schedule
        assert got.t_zero_contention * (1 - 1e-9) <= got.t_est \
            <= s.t_serial * (1 + 1e-9), part
        assert got.t_est >= s.t_dataflow * (1 - 1e-9), part
    # an explicit core_of (cores 0 and 12 sit on CMGs 0 and 1)
    if n_cores == 48 and len(pt_prog.ops):
        core_of = np.arange(len(pt_prog.ops)) % 2 * 12
        want = ref_node.schedule_node(
            ref_node.compile_node(ref_prog, ref_hw.A64FX_CORE),
            ref_hw.A64FX_CORE, n_cores, core_of=core_of)
        got = pt_node.schedule_node(
            pt_node.compile_node(pt_prog, pt_hw.A64FX_CORE),
            pt_hw.A64FX_CORE, n_cores, core_of=core_of)
        assert_node_equal(got, want)


def test_contention_shows_on_the_memory_bound_stream():
    """Not only equal: the 48-core estimate is strictly inside its bounds,
    so the fixpoint really ran (the reference harness's acceptance)."""
    _, prog = mem_bound_pair()
    t1 = pt_node.simulate_node(prog, pt_hw.A64FX_CORE, 1,
                               partition="shard").t_est
    for part in PARTITIONS:
        nr = pt_node.simulate_node(prog, pt_hw.A64FX_CORE, 48,
                                   partition=part)
        assert nr.t_zero_contention < nr.t_est < t1, part
        assert nr.iterations > 1 and nr.per_cmg[0].n_active["hbm2"] > 4.0


@pytest.mark.parametrize("seed", range(6))
def test_one_core_degenerate_equals_schedule_arrays(seed):
    """n_cores=1 under a degenerate topology replays schedule_arrays's
    float operations: equal to the port's and the reference's."""
    rng_r, rng_p = random.Random(seed), random.Random(seed)
    n = rng_p.randint(0, 48)
    rng_r.randint(0, 48)
    prog_r = random_program(rng_r, n, ref_hlo)
    prog = random_program(rng_p, n, pt_hlo)
    hw_r, hw = random_knobs(rng_r, ref_hw), random_knobs(rng_p, pt_hw)
    cp = pt_compiled.compile_program(prog, hw)
    t_arr, stall = pt_compiled.schedule_arrays(cp, hw)
    assert t_arr == ref_compiled.schedule_arrays(
        ref_compiled.compile_program(prog_r, hw_r), hw_r)[0]
    for part in PARTITIONS:
        nr = pt_node.simulate_node(prog, hw, 1,
                                   pt_hw.NodeTopology.degenerate(1), part)
        assert nr.t_est == t_arr and nr.t_zero_contention == t_arr, part
        assert nr.schedule.stall_by_reason == stall and nr.iterations == 1


@pytest.mark.parametrize("n_cores", CORES)
@pytest.mark.parametrize("name", ["dag1", "indep", "mem"])
def test_shard_costed_equals_the_reference(name, n_cores):
    _, ref_prog, pt_prog = next(p for p in PROGRAMS if p[0] == name)
    want = ref_node.shard_costed(ref_prog, ref_hw.A64FX_CORE, n_cores,
                                 compute_dtype="f64")
    got = pt_node.shard_costed(pt_prog, pt_hw.A64FX_CORE, n_cores,
                               compute_dtype="f64")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert (g.t_compute, g.t_mem, g.t_ici, g.port, g.op.name) \
                == (w.t_compute, w.t_mem, w.t_ici, w.port, w.op.name)
    # the knob sweep rides schedule_batch on it, as the reference's does
    cr = ref_compiled.compile_program(ref_prog, ref_hw.A64FX_CORE,
                                      costed=want)
    cp = pt_compiled.compile_program(pt_prog, pt_hw.A64FX_CORE, costed=got)
    assert np.array_equal(cp.durations, cr.durations)


@pytest.mark.parametrize("n_cores,part", [(48, "shard"), (48, "round-robin"),
                                          (12, "graph"), (1, "round-robin")])
@pytest.mark.parametrize("hlo", [CHAIN_HLO, INDEP_HLO], ids=["chain", "indep"])
def test_simulate_node_engine_equals_the_reference(hlo, n_cores, part):
    kw = dict(engine="node", n_cores=n_cores, node_partition=part,
              compute_dtype="f64")
    want = ref_simulate.simulate(hlo, hw=ref_hw.A64FX_CORE, **kw)
    got = pt_simulate.simulate(hlo, hw=pt_hw.A64FX_CORE, **kw)
    assert got.t_est == want.t_est == got.node.t_est
    assert got.pa == want.pa
    assert got.to_json() == want.to_json()
    assert_node_equal(got.node, want.node)
    assert f"node engine ({n_cores} cores, partition={part}" in got.pa
    assert "zero-contention bound" in got.pa
    d = json.loads(got.to_json())
    assert d["node"]["n_cores"] == n_cores
    assert len(d["node"]["per_cmg"]) == max(1, -(-n_cores // 12))


def test_simulate_node_rejects_what_the_reference_rejects():
    for kw in (dict(n_cores=49), dict(n_cores=2, node_partition="zigzag")):
        with pytest.raises(ValueError):
            ref_simulate.simulate(INDEP_HLO, hw=ref_hw.A64FX_CORE,
                                  engine="node", **kw)
        with pytest.raises(ValueError):
            pt_simulate.simulate(INDEP_HLO, hw=pt_hw.A64FX_CORE,
                                 engine="node", **kw)
    for sim, hw in ((ref_simulate, ref_hw), (pt_simulate, pt_hw)):
        with pytest.raises(ValueError, match="engine='node'"):
            sim.simulate(INDEP_HLO, hw=hw.A64FX_CORE, engine="schedule",
                         sampling=object())

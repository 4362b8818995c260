"""The port's simulator core is the reference's, bit for bit.

The same HLO text goes through ``repro.core`` and ``repro_torch.core``:
the literal programs of test_core_simulator.py, test_schedule_engine.py and
test_memory_hierarchy.py, the small jnp functions those files compile, and
the 28 Table-1 kernels (``ref.elementwise_ref`` under x64).  Parsed
programs, costed lists, both engines, the interpreter scheduler, the
batched O3 sweep, ``SimReport.to_json()`` and the PA text must be equal
(``==``, no tolerance) under TPU_V5E, A64FX_CORE and CPU_HOST.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import compiled as ref_compiled
from repro.core import cost as ref_cost
from repro.core import engine as ref_engine
from repro.core import hlo as ref_hlo
from repro.core import hwspec as ref_hw
from repro.core import schedule as ref_schedule
from repro.core import simulate as ref_simulate
from repro.kernels import ref as jref
from repro.kernels.stream import _DTYPES, EXPRS
from repro_torch.core import calibrate as cal
from repro_torch.core import compiled as pt_compiled
from repro_torch.core import cost as pt_cost
from repro_torch.core import engine as pt_engine
from repro_torch.core import hlo as pt_hlo
from repro_torch.core import hwspec as pt_hw
from repro_torch.core import schedule as pt_schedule
from repro_torch.core import simulate as pt_simulate

# test_schedule_engine.py and test_memory_hierarchy.py
INDEP_HLO = """
HloModule indep, num_partitions=1

ENTRY %main (p0: f32[4096,4096], p1: f32[134217728]) -> (f32[4096,4096], f32[134217728]) {
  %p0 = f32[4096,4096] parameter(0)
  %p1 = f32[134217728] parameter(1)
  %big = f32[134217728] copy(%p1)
  %dot = f32[4096,4096] dot(%p0, %p0), lhs_contracting_dims={1}
  ROOT %t = (f32[4096,4096], f32[134217728]) tuple(%dot, %big)
}
"""
CHAIN_HLO = """
HloModule chain, num_partitions=1

ENTRY %main (p0: f32[4096,4096]) -> f32[4096,4096] {
  %p0 = f32[4096,4096] parameter(0)
  %dot = f32[4096,4096] dot(%p0, %p0), lhs_contracting_dims={1}
  %e = f32[4096,4096] exponential(%dot)
  %dot2 = f32[4096,4096] dot(%e, %e), lhs_contracting_dims={1}
  ROOT %neg = f32[4096,4096] negate(%dot2)
}
"""
# test_core_simulator.py
ALLREDUCE_HLO = """
HloModule m, num_partitions=16

ENTRY %main (p0: f32[1024,256]) -> f32[1024,256] {
  %p0 = f32[1024,256] parameter(0)
  %ag = f32[1024,256] all-reduce(%p0), replica_groups=[16,16]<=[256]
  ROOT %out = f32[1024,256] add(%ag, %ag)
}
"""
# test_schedule_engine.py
COLL_HLO = """
HloModule coll, num_partitions=4

ENTRY %main (p0: f32[4096,4096], p1: f32[4096,4096]) -> (f32[4096,4096], f32[4096,4096]) {
  %p0 = f32[4096,4096] parameter(0)
  %p1 = f32[4096,4096] parameter(1)
  %ar = f32[4096,4096] all-reduce(%p1), replica_groups=[4,4]<=[16]
  %dot = f32[4096,4096] dot(%p0, %p0), lhs_contracting_dims={1}
  ROOT %t = (f32[4096,4096], f32[4096,4096]) tuple(%dot, %ar)
}
"""
LITERALS = {"indep": INDEP_HLO, "chain": CHAIN_HLO,
            "allreduce": ALLREDUCE_HLO, "coll": COLL_HLO}


def _scan_dots(a):
    def body(c, _):
        return c @ a, None
    return jax.lax.scan(body, a, None, length=9)[0]


def _scan_rows(xs):
    def body(c, x):
        return c + x, c[0]
    return jax.lax.scan(body, jnp.zeros((256, 256)), xs)


# the jnp functions test_core_simulator.py compiles, and their inputs
COMPILED = {
    "dot": (lambda a, b: a @ b, (jnp.ones((64, 128)), jnp.ones((128, 32)))),
    "scan_dots": (_scan_dots, (jnp.ones((32, 32)),)),
    "exp_sin": (lambda x: jnp.exp(x) + jnp.sin(x), (jnp.ones((1024,)),)),
    "scan_rows": (_scan_rows, (jnp.ones((16, 256, 256)),)),
}
SPECS = ("tpu_v5e", "a64fx_core", "cpu_host")
NAMES = [*LITERALS, *COMPILED, *(f"k1_{k}" for k in EXPRS)]


def _kernel_hlo(name: str, n: int = 4096) -> str:
    fn, n_in, din, dout = EXPRS[name]
    with jax.enable_x64(True):
        x1 = jnp.ones((n,), _DTYPES[din])
        x2 = jnp.ones((n,), _DTYPES["f8" if din == "i4" else din])
        y0 = jnp.zeros((n,), _DTYPES[dout])
        f = jax.jit(lambda a, b, y: jref.elementwise_ref(name, a, b, y))
        return f.lower(x1, x2, y0).compile().as_text()


@pytest.fixture(scope="module")
def texts():
    out = dict(LITERALS)
    for name, (fn, args) in COMPILED.items():
        out[name] = jax.jit(fn).lower(*args).compile().as_text()
    for name in EXPRS:
        out[f"k1_{name}"] = _kernel_hlo(name)
    return out


def _sched_view(s):
    return {"t_est": s.t_est, "t_roofline": s.t_roofline,
            "t_serial": s.t_serial, "t_dataflow": s.t_dataflow,
            "port_busy": s.port_busy, "n_ops": s.n_ops, "n_edges": s.n_edges,
            "stall_by_reason": s.stall_by_reason,
            "issue_width": s.issue_width, "bound_by": s.bound_by,
            "overlap_fraction": s.overlap_fraction,
            "critical_path": [(c.op.name, c.port, c.start, c.finish,
                               c.bound_by) for c in s.critical_path],
            "critical_path_truncated": s.critical_path_truncated}


def _json_without_xla(rep):
    d = json.loads(rep.to_json())
    for key in ("xla_cost_analysis", "memory_analysis"):
        assert key in d
        del d[key]
    return d


def test_specs_are_the_reference_specs():
    """Every spec the reference has, the port has with equal values; the
    port adds H100."""
    for name, spec in ref_hw.SPECS.items():
        assert dataclasses.asdict(pt_hw.SPECS[name]) \
            == dataclasses.asdict(spec), name
    assert set(pt_hw.SPECS) == set(ref_hw.SPECS) | {"h100"}


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", NAMES)
def test_parse_cost_engines_report_match(texts, name, spec):
    text = texts[name]
    hw_r, hw_p = ref_hw.SPECS[spec], pt_hw.SPECS[spec]
    prog_r, prog_p = ref_hlo.parse_program(text), pt_hlo.parse_program(text)
    assert dataclasses.asdict(prog_p) == dataclasses.asdict(prog_r)
    for dtype in (None, "bf16", "f64"):
        cr = ref_cost.cost_program(prog_r, hw_r, compute_dtype=dtype)
        cp = pt_cost.cost_program(prog_p, hw_p, compute_dtype=dtype)
        assert [None if c is None else dataclasses.asdict(c) for c in cp] \
            == [None if c is None else dataclasses.asdict(c) for c in cr]
        er = ref_engine.simulate_program(prog_r, hw_r, compute_dtype=dtype)
        ep = pt_engine.simulate_program(prog_p, hw_p, compute_dtype=dtype)
        assert dataclasses.asdict(ep) == dataclasses.asdict(er)
        for detail in (False, True):
            sr = ref_schedule.schedule_program(prog_r, hw_r,
                                               compute_dtype=dtype,
                                               detail=detail)
            sp = pt_schedule.schedule_program(prog_p, hw_p,
                                              compute_dtype=dtype,
                                              detail=detail)
            assert _sched_view(sp) == _sched_view(sr)
        assert _sched_view(pt_schedule.schedule_reference(
            prog_p, hw_p, compute_dtype=dtype)) == _sched_view(
            ref_schedule.schedule_reference(prog_r, hw_r, compute_dtype=dtype))
    for engine in ("occupancy", "schedule", "both"):
        rr = ref_simulate.simulate(text, hw=hw_r, compute_dtype="f32",
                                   engine=engine, title=name)
        rp = pt_simulate.simulate(text, hw=hw_p, compute_dtype="f32",
                                  engine=engine, title=name)
        assert _json_without_xla(rp) == _json_without_xla(rr)
        assert rp.pa == rr.pa
        assert rp.t_est == rr.t_est


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", NAMES)
def test_schedule_batch_matches_over_the_default_knob_grid(texts, name, spec):
    """The batched O3 sweep of ``sweep_o3``: the port's ``default_o3_knobs``
    against the reference's grid rebuilt from the constants at
    calibrate.py:316-319 (the reference's calibrate cannot be imported under
    jax 0.9)."""
    hw_r, hw_p = ref_hw.SPECS[spec], pt_hw.SPECS[spec]
    assert (cal.O3_WINDOWS, cal.O3_MEM_WIDTHS, cal.O3_VPU_WIDTHS,
            cal.O3_QUEUE_DEPTHS) == ((4, 16, 64, 256, 1024), (1, 2, 4),
                                     (1, 2), (4, 16, 64))
    combos = [(w, mw, vw, qd) for w in cal.O3_WINDOWS
              for mw in cal.O3_MEM_WIDTHS for vw in cal.O3_VPU_WIDTHS
              for qd in cal.O3_QUEUE_DEPTHS]
    knobs_r = ref_compiled.O3Knobs.from_grid(hw_r, combos)
    knobs_p = cal.default_o3_knobs(hw_p)
    for field in ("window", "width", "depth"):
        assert np.array_equal(getattr(knobs_p, field), getattr(knobs_r, field))
    text = texts[name]
    cr = ref_compiled.compile_program(ref_hlo.parse_program(text), hw_r,
                                      compute_dtype="f64")
    cp = pt_compiled.compile_program(pt_hlo.parse_program(text), hw_p,
                                     compute_dtype="f64")
    tr = ref_compiled.schedule_batch(cr, knobs_r)
    tp = pt_compiled.schedule_batch(cp, knobs_p)
    assert tp.dtype == tr.dtype and np.array_equal(tp, tr)
    assert pt_compiled.schedule_arrays(cp, hw_p) \
        == ref_compiled.schedule_arrays(cr, hw_r)


def test_unported_backends_and_engines_raise():
    """The reference's jax backend raises, naming the port's ``torch``
    (its plain version on the CPU equals NumPy); the node engine is ported
    (test_torch_node.py); ``sampling=`` outside ``engine="node"`` raises
    as the reference's does (sampled estimation: test_torch_sample.py)."""
    prog = pt_hlo.parse_program(CHAIN_HLO)
    cp = pt_compiled.compile_program(prog, pt_hw.TPU_V5E)
    knobs = cal.default_o3_knobs(pt_hw.TPU_V5E)
    with pytest.raises(ValueError, match="torch"):
        pt_compiled.schedule_batch(cp, knobs, backend="jax")
    assert np.array_equal(
        pt_compiled.schedule_batch(cp, knobs, backend="torch", device="cpu"),
        pt_compiled.schedule_batch(cp, knobs))
    rep = pt_simulate.simulate(CHAIN_HLO, engine="node")
    assert rep.node is not None and rep.t_est == rep.node.t_est
    for sim in (ref_simulate, pt_simulate):
        with pytest.raises(ValueError, match="engine='node'"):
            sim.simulate(CHAIN_HLO, sampling=object())
    rep = pt_simulate.simulate(prog, engine="both")   # a Program is accepted
    assert rep.xla_cost_analysis is None and rep.memory_analysis is None
    assert rep.to_json() == pt_simulate.simulate(CHAIN_HLO,
                                                 engine="both").to_json()

"""``kernel_program`` against the reference's parse of the same expression.

The port describes one K1 launch as a ``Program`` directly (it imports no
JAX); the reference compiles ``ref.elementwise_ref`` with XLA and parses the
HLO (``calibrate.py:294-297``).  For all 28 Table-1 kernels at two sizes the
two must agree on bytes read and written, on transcendental counts by
opcode, and on plain-elementwise counts by opcode once XLA's constant
``broadcast``s are dropped (they are no operations of K1), except where
XLA's program differs from K1's for the reasons in ``EXCEPTIONS``.  Where
the programs agree, they cost to the same time under CPU_HOST.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.core import cost as ref_cost
from repro.core import hwspec as ref_hw
from repro.core.hlo import Program as RefProgram
from repro.core.hlo import parse_program
from repro.kernels import ref as jref
from repro.kernels.stream import _DTYPES, EXPRS
from repro_torch.core import cost as pt_cost
from repro_torch.core import hwspec as pt_hw
from repro_torch.core.calibrate import kernel_program

# kernel -> (fields that differ, why)
EXCEPTIONS = {
    "mod": ({"bytes", "vpu"},
            "XLA splits a/b into a fusion of its own and re-reads a and b in "
            "a second one (56 B an element against K1's 24), and writes "
            "trunc as ceil/floor/compare/select; K1 runs one pass with one "
            "rounding instruction, named round-nearest-even"),
    "aint": ({"vpu"},
             "XLA writes trunc as compare/ceil/floor/select; K1 runs one "
             "f64 rounding instruction (FRND), named round-nearest-even"),
    "sign": ({"vpu"},
             "XLA writes copysign as shift/compare/abs/negate/select; K1 runs "
             "abs and a bitwise merge of the sign bit (LOP3), named abs and "
             "and"),
}
SIZES = (4096, 3 * 8192)


def _reference_program(name: str, n: int) -> RefProgram:
    fn, n_in, din, dout = EXPRS[name]
    with jax.enable_x64(True):
        args = (jnp.ones((n,), _DTYPES[din]),
                jnp.ones((n,), _DTYPES["f8" if din == "i4" else din]),
                jnp.zeros((n,), _DTYPES[dout]))
        f = jax.jit(lambda a, b, y: jref.elementwise_ref(name, a, b, y))
        return parse_program(f.lower(*args).compile().as_text())


def _totals(prog, attr):
    out = {}
    for o in prog.ops:
        for k, v in getattr(o, attr).items():
            out[k] = out.get(k, 0.0) + v * o.count
    return out


def _without_broadcast(prog: RefProgram) -> RefProgram:
    ops = []
    for o in prog.ops:
        nb = o.vpu_by_opcode.get("broadcast", 0.0)
        ops.append(dataclasses.replace(
            o, flops=o.flops - nb,
            vpu_by_opcode={k: v for k, v in o.vpu_by_opcode.items()
                           if k != "broadcast"}))
    return dataclasses.replace(prog, ops=ops)


@pytest.fixture(scope="module")
def reference_programs():
    return {(name, n): _reference_program(name, n)
            for name in EXPRS for n in SIZES}


def test_exceptions_are_named_kernels():
    assert set(EXCEPTIONS) <= set(EXPRS)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(EXPRS))
def test_kernel_program_matches_the_reference_parse(reference_programs,
                                                    name, n):
    ref = _without_broadcast(reference_programs[name, n])
    prog = kernel_program(name, n)
    (op,) = prog.ops
    differs = EXCEPTIONS.get(name, (set(), ""))[0]
    assert op.opclass == "elementwise" and op.count == 1.0
    assert op.dtype == ref.ops[-1].dtype
    if "bytes" not in differs:
        assert (prog.total("read_bytes"), prog.total("write_bytes"),
                prog.bytes_accessed) == (ref.total("read_bytes"),
                                         ref.total("write_bytes"),
                                         ref.bytes_accessed)
    else:
        assert prog.bytes_accessed < ref.bytes_accessed
    assert _totals(prog, "trans_by_opcode") == _totals(ref, "trans_by_opcode")
    assert prog.total("transcendentals") == ref.total("transcendentals")
    if "vpu" not in differs:
        assert _totals(prog, "vpu_by_opcode") == _totals(ref, "vpu_by_opcode")
        assert prog.flops == ref.flops
    if not differs:
        # the same program costs the same under the reference's pipeline and
        # the port's; with XLA's broadcasts left in, the reference's costs
        # one flop an element more per broadcast and nothing else
        assert len(ref.ops) == 1
        raw = reference_programs[name, n]
        n_bcast = raw.ops[0].vpu_by_opcode.get("broadcast", 0.0)
        hw_r, hw_p = ref_hw.CPU_HOST, pt_hw.CPU_HOST
        (cr,) = ref_cost.cost_program(ref, hw_r, compute_dtype="f64")
        (cp,) = pt_cost.cost_program(prog, hw_p, compute_dtype="f64")
        (craw,) = ref_cost.cost_program(raw, hw_r, compute_dtype="f64")
        assert (cp.t_compute, cp.t_mem, cp.port) \
            == (cr.t_compute, cr.t_mem, cr.port)
        assert craw.t_mem == cp.t_mem
        assert craw.t_compute == pytest.approx(
            cp.t_compute + n_bcast / hw_r.vector_flops("f64"), rel=1e-12)

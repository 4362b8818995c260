"""The port's ATen frontend (``repro_torch.core.aten``) against the
reference's HLO parser, and its lowering rules on small graphs.

Reduced chatglm3-6b's train step (batch 4, 64 tokens, f32): the XLA:CPU HLO
of the reference's step through ``repro.core.hlo.parse_program`` and the
port's capture through ``aten.parse_graph`` carry the same matmul-class
FLOPs, exactly (704,643,072).  The byte totals differ by design (XLA
fuses, eager PyTorch runs one kernel an op; PERF.md explains the gap).
The SSM and hybrid models are in ``test_torch_aten_ssm.py``, so that the
two files run on two test workers.  ``repro.core.calibrate`` is not
imported (it fails under jax 0.9).
"""
import importlib.util
from pathlib import Path

import pytest
import torch
from _aten_ref import programs

from repro.core import hlo as ref_hlo
from repro_torch.core import aten
from repro_torch.core import hlo as pt_hlo
from repro_torch.core.cost import cost_program
from repro_torch.core.hwspec import H100
from repro_torch.core.simulate import simulate

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chatglm3_train_step_matmul_flops_equal_the_reference():
    ref, port, _ = programs("chatglm3-6b", "train")
    got = port.by_class()["matmul"]["flops"]
    assert got == ref.by_class()["matmul"]["flops"] == 704_643_072
    assert port.exact_dtypes
    # every dot is a mm/bmm of the port, none is hidden in another class
    assert {o.opcode for o in port.ops if o.opclass == "matmul"} == {"dot"}
    assert all(o.dot_dims for o in port.ops if o.opcode == "dot")


def _ops(fn, *args):
    return aten.parse_graph(aten.capture(fn, *args)).ops


def test_views_cost_nothing_and_reads_count_the_view():
    x = torch.randn(8, 16, 4)
    # view, permute, transpose, unsqueeze, squeeze: free; the add reads x
    ops = _ops(lambda x: x.view(8, 64).t().unsqueeze(0).squeeze(0) + 1.0, x)
    assert [o.opcode for o in ops] == ["add"]
    assert ops[0].read_bytes == ops[0].write_bytes == x.numel() * 4
    # I-2: a slice reads its own elements, not the base's
    (mul,) = _ops(lambda x: x[:, :4] * 2.0, x)
    assert mul.read_bytes == 8 * 4 * 4 * 4 and mul.write_bytes == 8 * 4 * 4 * 4
    # a stride-0 expand reads its base once
    b = torch.randn(8, 1, 4)
    (add,) = _ops(lambda b, x: b.expand(8, 16, 4) + x, b, x)
    assert add.read_bytes == (b.numel() + x.numel()) * 4
    # an allocation that nothing reads (left by decompositions on CUDA)
    assert [o.opcode for o in _ops(lambda x: (torch.empty(4, 8), x + 1)[1],
                                   x)] == ["add"]


def test_dep_edges_follow_the_graph():
    a, b = torch.randn(32, 64), torch.randn(64, 16)

    def fn(a, b):
        c = a @ b                       # 0
        d = torch.exp(c)                # 1 <- 0
        e = a.sum(dim=1, keepdim=True)  # 2 <- (a parameter)
        return d.t() * e.t()            # 3 <- 1, 2 (through the views)

    ops = _ops(fn, a, b)
    assert [o.opcode for o in ops] == ["dot", "exponential", "reduce",
                                       "multiply"]
    assert [o.deps for o in ops] == [[], [0], [], [1, 2]]
    assert ops[3].dep_bytes == [32 * 16 * 4, 32 * 4]
    assert ops[0].dot_dims == (32, 16, 64) and ops[0].flops == 2 * 32 * 16 * 64
    assert ops[1].trans_by_opcode == {"exponential": 32 * 16}
    assert ops[3].vpu_by_opcode == {"multiply": 16 * 32}


def test_in_place_write_costs_the_region_and_orders_its_readers():
    def fn(cache, new):
        cache[:, 2:4].copy_(new)        # 0: the region, read and written
        return cache.sum()              # 1 <- 0

    ops = _ops(fn, torch.zeros(4, 8, 16), torch.ones(4, 2, 16))
    assert [o.opcode for o in ops] == ["copy", "reduce"]
    assert ops[0].read_bytes == ops[0].write_bytes == 4 * 2 * 16 * 4
    assert ops[1].deps == [0]


def test_composites_arrive_whole():
    x = torch.randn(4, 32)
    ops = _ops(lambda x: torch.nn.functional.silu(x) + torch.softmax(x, -1),
               x)
    assert [o.opcode for o in ops] == ["fusion", "fusion", "add"]
    assert ops[0].trans_by_opcode == {"logistic": 128}
    assert ops[0].vpu_by_opcode == {"multiply": 128}
    assert ops[0].flops == 256 and ops[0].transcendentals == 128


def test_an_unmapped_op_raises_and_names_itself():
    x, edges = torch.rand(16), torch.linspace(0, 1, 5)
    gm = aten.capture(lambda x, e: torch.bucketize(x, e), x, edges)
    with pytest.raises(NotImplementedError, match="bucketize"):
        aten.parse_graph(gm)


def test_every_opcode_is_one_the_hlo_parser_classifies():
    known = (pt_hlo.TRANSCENDENTAL | pt_hlo.ELEMENTWISE | pt_hlo.REDUCE
             | pt_hlo.DATA_MOVEMENT | {"dot", "convolution"})
    assert set(aten.OPCODES.values()) <= known
    for parts in aten.COMPOSITES.values():
        assert set(parts["trans"]) <= pt_hlo.TRANSCENDENTAL
        assert set(parts["vpu"]) <= pt_hlo.ELEMENTWISE
    # the decomposition table keeps the composites whole
    assert not {aten._packet(op) for op in aten.decompositions()} \
        & set(aten.COMPOSITES)


F32_ADD_HLO = """
HloModule add, num_partitions=1

ENTRY %main (p0: f32[1048576], p1: f32[1048576]) -> f32[1048576] {
  %p0 = f32[1048576] parameter(0)
  %p1 = f32[1048576] parameter(1)
  ROOT %add = f32[1048576] add(%p0, %p1)
}
"""


def test_f32_ops_of_an_aten_program_cost_at_full_width_under_bf16():
    """XLA:CPU widens bf16 to f32, so the cost model halves the bytes of an
    HLO program's f32 ops when it computes in bf16 (DESIGN.md §7); an ATen
    program's f32 ops are f32 on the device and are not halved."""
    x = torch.randn(1 << 20)
    prog = aten.parse_graph(aten.capture(lambda a, b: a + b, x, x))
    hlo_prog = pt_hlo.parse_program(F32_ADD_HLO)
    assert prog.ops[0].bytes_accessed == hlo_prog.ops[0].bytes_accessed \
        == 3 * 4 * (1 << 20)
    assert prog.bytes_normalized("bf16") == prog.bytes_accessed
    assert hlo_prog.bytes_normalized("bf16") == hlo_prog.bytes_accessed / 2
    for p, scale in ((prog, 1.0), (hlo_prog, 0.5)):
        (t_bf16,) = cost_program(p, H100, compute_dtype="bf16")
        (t_f32,) = cost_program(p, H100, compute_dtype="f32")
        assert t_bf16.t_mem == pytest.approx(scale * t_f32.t_mem, rel=1e-12)
    # the HLO program is the reference's, field for field
    ref_prog = ref_hlo.parse_program(F32_ADD_HLO)
    assert ref_prog.bytes_normalized("bf16") \
        == hlo_prog.bytes_normalized("bf16")


def test_simulate_takes_a_captured_graph():
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    gm = aten.capture(lambda a, b: torch.tanh(a @ b).sum(), a, b)
    rep = simulate(gm, hw=H100, engine="both")
    want = simulate(aten.parse_graph(gm), hw=H100, engine="both")
    assert rep.t_est == want.t_est and rep.schedule.t_est == want.schedule.t_est
    assert rep.xla_cost_analysis is None and rep.memory_analysis is None
    assert rep.program.exact_dtypes
    assert [o.opcode for o in rep.program.ops] == ["dot", "tanh", "reduce"]


def test_quickstart_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    report = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 4: loss" in out and "quickstart OK" in out
    assert "== PA report chatglm3-6b quickstart (torch) ==" in out
    assert "schedule engine (dependency-aware O3)" in out
    assert report.hw == "h100" and report.t_est > 0
    assert report.program.by_class()["matmul"]["flops"] == 704_643_072


def _ref_ops(fn, *shapes):
    """The reference's parse of ``fn`` compiled by XLA:CPU over f32 inputs."""
    import jax
    import jax.numpy as jnp
    args = [jnp.zeros(s, jnp.float32) for s in shapes]
    return ref_hlo.parse_program(
        jax.jit(fn).lower(*args).compile().as_text()).ops


def test_argmax_and_argmin_lower_as_the_references_variadic_reduce():
    """XLA writes ``jnp.argmax`` as one variadic reduce over the values and
    an iota (fused with the iota), which the reference's parser charges an
    element of each operand, plus its two init scalars.  The port charges
    the same pair an element: the serving decode step's argmax parses."""
    import jax.numpy as jnp
    x = torch.randn(2, 1000)
    ops = _ops(lambda x: (torch.argmax(x, -1), torch.argmin(x, 0)), x)
    assert [(o.opcode, o.opclass, o.dtype) for o in ops] \
        == [("reduce", "reduce", "s64")] * 2
    assert ops[0].flops == ops[1].flops == 2 * 2000
    assert ops[0].read_bytes == 8000 and ops[0].write_bytes == 2 * 8
    (ref,) = _ref_ops(lambda x: jnp.argmax(x, -1), (2, 1000))
    iota = ref.vpu_by_opcode["iota"]
    assert ops[0].flops == ref.flops - iota - 2      # less the init scalars


def test_relu_lowers_to_an_elementwise_max_with_zero():
    """nemotron-4-340b's squared ReLU: ``relu`` is a ``maximum``, as
    ``jnp.maximum(x, 0)`` is in the reference's HLO."""
    import jax.numpy as jnp
    x = torch.randn(4, 500)
    ops = _ops(lambda x: torch.relu(x), x)
    assert [(o.opcode, o.opclass) for o in ops] == [("maximum", "elementwise")]
    assert ops[0].vpu_by_opcode == {"maximum": 2000} and ops[0].flops == 2000
    (ref,) = _ref_ops(lambda x: jnp.maximum(x, 0), (4, 500))
    assert ref.vpu_by_opcode["maximum"] == ops[0].vpu_by_opcode["maximum"]

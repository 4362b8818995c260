"""The ATen frontend on the moe, vlm and audio families, against the
reference, and the lowering rules their graphs add.

Reduced grok-1-314b, llama4-scout-17b-a16e, paligemma-3b and
whisper-large-v3 (batch 4, 64 tokens, f32, ``blocked`` attention): the
XLA:CPU HLO of the reference's train step and prefill through
``repro.core.hlo.parse_program`` against the port's capture through
``aten.parse_graph`` (``tests/_aten_ref.py``): the matmul-class FLOPs are
equal (the dots' (M, N, K) are not compared: XLA folds the experts' and
heads' batch axes into other dimensions than the port's ``bmm``s do, and
transposes the backward's dots otherwise).  The flash prefills hold one K3 custom call per
attention layer that runs it (whisper: the encoder's and the decoder's
self-attention; cross-attention runs ``blocked``, as in the reference).
"""
import pytest
import torch
from _aten_ref import programs

from repro_torch.configs import ARCHS, ShapeConfig, reduced_config
from repro_torch.core import aten
from repro_torch.models.lm import build_model

FAMILY_ARCHS = ["grok-1-314b", "llama4-scout-17b-a16e", "paligemma-3b",
                "whisper-large-v3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("what", ["train", "prefill"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_matmul_flops_match_the_reference(arch, what):
    ref, port, _ = programs(arch, what)
    assert port.by_class()["matmul"]["flops"] \
        == ref.by_class()["matmul"]["flops"] > 0


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_flash_prefill_holds_one_custom_call_per_k3_layer(arch):
    cfg = reduced_config(ARCHS[arch])
    model = build_model(cfg, attn_impl="flash")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             model.input_specs(ShapeConfig("t", 16, 1, "prefill"),
                               torch.float32).items()}

    def prefill(params, batch):
        with torch.no_grad():
            return model.prefill_fn(params, batch)

    prog = aten.parse_graph(aten.capture(prefill, params, batch))
    calls = [o for o in prog.ops if o.opcode == "custom-call"]
    assert len(calls) == cfg.n_layers + cfg.n_encoder_layers


def _ops(fn, *args):
    return aten.parse_graph(aten.capture(fn, *args)).ops


def test_routing_ops_lower_to_the_references_opcodes():
    """argsort and topk -> sort (data movement), searchsorted -> compare at
    ceil(log2(N + 1)) compares an output element, any -> reduce."""
    e = torch.randint(0, 8, (2, 64))
    ops = _ops(lambda e: torch.searchsorted(
        torch.sort(e, dim=-1, stable=True).values,
        torch.arange(8).expand(2, 8).contiguous()), e)
    assert [o.opcode for o in ops] == ["sort", "iota", "copy", "compare"]
    assert ops[0].opclass == "data"
    assert ops[3].flops == 2 * 8 * 7 and ops[3].vpu_by_opcode == {
        "compare": 2 * 8 * 7}
    p = torch.rand(4, 16, 8)
    ops = _ops(lambda p: torch.topk(p, 2, dim=-1).values.sum()
               + (p > 0.5).any(dim=1).sum(), p)
    assert [o.opcode for o in ops][:1] == ["sort"]
    assert "reduce" in [o.opcode for o in ops]


def test_in_place_scatters_cost_the_written_region():
    """scatter_ and index_add_ write in place (I-3): the region written,
    read and written, and later readers depend on them."""
    src, idx = torch.arange(16.0), torch.randint(0, 40, (16,))

    def f(src, idx):
        out = torch.zeros(40)
        out.scatter_(0, idx, src)
        acc = torch.zeros(40, 3).index_add_(0, idx, src[:, None].expand(16, 3))
        return out * 2, acc

    ops = _ops(f, src, idx)
    scatters = [o for o in ops if o.opcode == "scatter"]
    assert len(scatters) == 2
    assert scatters[0].read_bytes == scatters[0].write_bytes == 16 * 4
    mul = next(o for o in ops if o.opcode == "multiply")
    assert ops.index(scatters[0]) in mul.deps


def test_int8_quantize_lowers_with_real_dtypes():
    from repro_torch.models.attention import quantize_kv
    ops = _ops(quantize_kv, torch.randn(1, 4, 2, 32))
    assert "round-nearest-even" in [o.opcode for o in ops]
    assert {o.dtype for o in ops if o.opcode == "convert"} >= {"s8", "f16"}

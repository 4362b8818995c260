"""The loop-aware capture (``core.aten.repeat``, ``capture(loops=True)``):
a microbatch or layer loop traced once and counted its trips, as the
reference's parse counts a ``lax.scan`` body (``core.aten``'s I-4).

* The train steps of the seven architectures whose production train cells
  an unrolled capture cannot finish (ROADMAP queue 3, item 15), at reduced
  width, 4 layers and 2 microbatches (``tests/_loops.py``): the
  loop-aware Program's count-weighted matmul, elementwise and
  transcendental FLOPs, op instances and bytes equal the unrolled
  capture's.  The byte gap reckoned from the shapes is zero: a stacked
  parameter's gradient is the stack of its n layer slices, read and
  written, in both captures (``unbind``'s backward unrolled, ``_Slice``'s
  loop-aware), and a stacked output the stack of n layer outputs.  The
  argument and output bytes are equal, the temp bytes within 0.9-1.1.
  Prefill and decode, and the other architectures, are in
  ``test_torch_aten_loops_kinds.py``; the (2, 2) mesh cells and their
  collectives in ``test_torch_cell.py`` and
  ``test_torch_dryrun_memory.py``.
* A scanned stack holds the same graph nodes at 2 and at 8 layers;
  zamba2's hybrid stack, a Python loop in the reference too, grows.
* Counts multiply: a layer inside the microbatch loop counts
  n_micro x n_layers, its backward included.
* Against the reference: reduced chatglm3-6b's train step in 2
  microbatches, ``repro.core.hlo.parse_program`` of the reference's
  compiled step (its microbatch and layer scans) and the port's
  loop-aware Program hold the same matmul FLOPs in total and for each
  count.
* A loop-aware capture refuses tensors with storage; eager ``repeat`` is
  the Python loop; a body that reads a tensor needing a gradient from
  outside raises.
"""
import collections

import pytest
import torch
from _loops import assert_equal_programs, captures, fake, loop_nodes, step

from repro_torch.core import aten

FOURTEEN = ["zamba2-1.2b", "nemotron-4-340b", "qwen1.5-110b", "mamba2-1.3b",
            "grok-1-314b", "qwen1.5-32b", "llama4-scout-17b-a16e"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FOURTEEN)
def test_train_step_equals_the_unrolled_capture(arch):
    unrolled, loops = captures(arch, "train")
    _, prog = assert_equal_programs(unrolled, loops)
    counts = {o.count for o in prog.ops}
    assert 2 in counts                      # the microbatch loop
    if arch != "zamba2-1.2b":               # the layers, inside it: 3 of
        assert max(counts) in (2 * 4, 2 * 3)  # them where layer 0 is traced
    else:                                   # on its own
        assert max(counts) == 2
    assert len(loops.graph.nodes) < len(unrolled.graph.nodes)


@pytest.mark.parametrize("arch,what", [
    ("chatglm3-6b", "train"), ("chatglm3-6b", "prefill"),
    ("mamba2-1.3b", "prefill"), ("whisper-large-v3", "prefill"),
    ("llama4-scout-17b-a16e", "decode")])
def test_a_scanned_stack_holds_its_nodes_at_any_depth(arch, what):
    assert loop_nodes(arch, what, 2) == loop_nodes(arch, what, 8)


def test_the_hybrid_stack_grows_as_the_references_loop():
    assert loop_nodes("zamba2-1.2b", "prefill", 8) > \
        loop_nodes("zamba2-1.2b", "prefill", 2)


def test_a_layer_in_the_microbatch_loop_counts_both_trips():
    fn, args = step("chatglm3-6b", "train", layers=3, micro=2)
    gm = aten.capture(fn, *fake(args), loops=True)
    prog = aten.parse_graph(gm)
    dots = collections.Counter(o.count for o in prog.ops
                               if o.opcode == "dot")
    assert set(dots) == {2 * 3, 2}          # layers; the head, a microbatch
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    # the layers' backward is tagged too: ops of the layer loop's backward
    bwd = [n for n in nodes if n.meta.get("loop_bwd") is not None]
    assert bwd and all(aten.trips(n) == 6 for n in bwd)
    assert {aten.trips(n) for n in nodes} == {1, 2, 6}


def test_matmul_flops_by_count_equal_the_references_parse():
    """Reduced chatglm3-6b (2 layers), batch 4 in 2 microbatches: the
    reference scans both loops and its parse multiplies the layers' dots
    by 2 x 2 and the head's by 2; the port's loop-aware Program does the
    same.  XLA hoists no dot out of either loop here."""
    from _aten_ref import programs
    ref, port, _ = programs("chatglm3-6b", "train", microbatch=2)

    def by_count(prog):
        out = collections.Counter()
        for o in prog.ops:
            if o.opclass == "matmul":
                out[o.count] += o.flops * o.count
        return dict(out)

    assert port.by_class()["matmul"]["flops"] \
        == ref.by_class()["matmul"]["flops"] > 0
    assert by_count(port) == by_count(ref)
    assert set(by_count(ref)) == {2.0, 4.0}


def test_a_loop_aware_capture_refuses_tensors_with_storage():
    fn, args = step("chatglm3-6b", "prefill", layers=2)
    with pytest.raises(ValueError, match="fake or meta tensors"):
        aten.capture(fn, *args, loops=True)


def test_eager_repeat_is_the_python_loop():
    w = torch.randn(3, 4, 4)
    x = torch.randn(2, 4)
    c = torch.zeros(3, 2)

    def body(h, i, wi, ci, s):
        ci.copy_(h.sum(-1))
        return torch.tanh(h @ wi) * s, h.sum()

    got, ys = aten.repeat(body, 3, x, xs=(w,), views=(c,), consts=(2.0,))
    want, wys = x, []
    for i in range(3):
        wys.append(want.sum())
        want = torch.tanh(want @ w[i]) * 2.0
    assert torch.equal(got, want)
    assert torch.equal(aten.stack(ys), torch.stack(wys))
    assert torch.equal(c[2], (torch.tanh(torch.tanh(x @ w[0]) * 2 @ w[1])
                              * 2).sum(-1))


def test_a_body_reading_a_gradient_from_outside_raises():
    def fn(w, u, x):
        w, u = w.requires_grad_(), u.requires_grad_()

        def body(h, i, wi):
            return h @ wi + u, None          # u: not passed in
        h, _ = aten.repeat(body, 3, x, xs=(w,))
        return torch.autograd.grad(h.sum(), [w, u])

    args = fake((torch.randn(3, 4, 4), torch.randn(4), torch.randn(2, 4)))
    with pytest.raises(NotImplementedError, match="consts"):
        aten.capture(fn, *args, loops=True)

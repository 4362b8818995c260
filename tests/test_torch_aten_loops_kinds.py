"""The loop-aware capture against the unrolled one on the other kinds of
step: reduced chatglm3-6b, mamba2-1.3b, whisper-large-v3,
llama4-scout-17b-a16e and zamba2-1.2b at 4 layers, prefill and decode
(``tests/_loops.py``), and the train steps of chatglm3-6b and
whisper-large-v3 in 2 microbatches (the other three archs' train steps
are in ``test_torch_aten_loops.py``).  The count-weighted FLOPs by class,
op instances, bytes (the byte gap reckoned from the shapes is zero, as
there), argument and output bytes are equal; the temp bytes within
0.9-1.1.  Whisper's encoder takes the frames, which need no gradient, so
its first layer's backward is smaller than the others' and is traced on
its own, as unrolled; llama4-scout's MoE carries its auxiliary loss from
a Python 0.0, so its first layer is too.
"""
import pytest
import torch
from _loops import assert_equal_programs, captures

ARCHS = ["chatglm3-6b", "mamba2-1.3b", "whisper-large-v3",
         "llama4-scout-17b-a16e", "zamba2-1.2b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,what", [
    *((a, w) for a in ARCHS for w in ("prefill", "decode")),
    ("chatglm3-6b", "train"), ("whisper-large-v3", "train")])
def test_loop_aware_capture_equals_the_unrolled_one(arch, what):
    unrolled, loops = captures(arch, what)
    _, prog = assert_equal_programs(unrolled, loops)
    counts = {o.count for o in prog.ops}
    if arch == "zamba2-1.2b":               # the hybrid stack is unrolled
        assert counts == {1}
    else:
        assert max(counts) > 1

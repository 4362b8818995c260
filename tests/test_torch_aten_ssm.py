"""The ATen frontend on the SSM and hybrid models, against the reference.

Reduced mamba2-1.3b and zamba2-1.2b (batch 4, 64 tokens, f32), the train
step and the prefill: the XLA:CPU HLO of the reference's step (its ``jnp``
SSD scan) through ``repro.core.hlo.parse_program`` against the port's
capture (its ``chunked`` scan) through ``aten.parse_graph``.  The
matmul-class FLOPs are equal, or differ by exactly the FLOPs of the one
einsum the two formulations write differently, reckoned from the shapes
(``_aten_ref.reckoned_matmul_gap``).  A separate file from
``test_torch_aten.py`` so that xdist's ``--dist loadfile`` runs the two on
two workers.
"""
import pytest
import torch
from _aten_ref import programs, reckoned_matmul_gap


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("what", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_matmul_flops_match_the_reference(arch, what):
    ref, port, _ = programs(arch, what)
    gap = reckoned_matmul_gap(arch, what)
    got = port.by_class()["matmul"]["flops"]
    want = ref.by_class()["matmul"]["flops"]
    assert got - want == gap
    if what == "train":
        assert gap < 0          # the reference's decay-gradient dot
    # the dots the port has are the reference's, shape for shape, but for
    # the reference's decay-gradient dot (M = N = 1, K = d_state)
    ref_dims = sorted({o.dot_dims for o in ref.ops if o.opclass == "matmul"
                       and o.dot_dims[:2] != (1, 1)})
    port_dims = sorted({o.dot_dims for o in port.ops
                        if o.opclass == "matmul"})
    assert port_dims == ref_dims

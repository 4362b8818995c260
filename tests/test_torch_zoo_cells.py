"""Every (arch, phase) cell of the port's model zoo captures and parses.

``zoo.trace_phase`` captures each reduced cell as an ATen graph over fake
CPU tensors (the train step with its optimizer state, the prefill, one
decode step over ``cache_abstract``) and parses it: the decode steps need
``aten.argmax``'s rule, nemotron-4-340b's squared-ReLU MLP ``aten.relu``'s.
On chatglm3-6b's and llama4-scout's prefill cells the matmul FLOPs equal
the reference zoo's compiled HLO's.
"""
import math

import pytest
import torch

from repro.core import zoo as ref_zoo
from repro_torch.configs import ARCHS, zoo_phases_for
from repro_torch.core import zoo
from repro_torch.core.hwspec import A64FX_CORE

CELLS = [(a, p) for a in sorted(ARCHS) for p in zoo_phases_for(ARCHS[a])]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,phase", CELLS)
def test_every_cell_captures_parses_and_estimates(arch, phase):
    prog = zoo.trace_phase(arch, phase)
    assert len(prog.ops) > 0 and prog.exact_dtypes
    assert prog.flops > 0 and prog.bytes_accessed > 0
    assert {o.count for o in prog.ops} == {1.0}          # eager, unrolled
    assert not any(o.opcode == "custom-call" for o in prog.ops)
    if phase == "decode":
        assert any(o.opcode == "reduce" and o.dtype == "s64"
                   for o in prog.ops)                        # the argmax
    pe = zoo.estimate_program(prog, A64FX_CORE, core_counts=(12,),
                              arch=arch, phase=phase)
    (ce,) = pe.per_core
    assert pe.n_costed > 0
    assert math.isfinite(ce.t_est_s) and ce.t_est_s > 0
    assert ce.t_zero_contention_s <= ce.t_est_s * (1 + 1e-9)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "llama4-scout-17b-a16e"])
def test_prefill_matmul_flops_equal_the_reference_zoo(arch):
    want = ref_zoo.trace_phase(arch, "prefill")
    got = zoo.trace_phase(arch, "prefill")
    assert got.by_class()["matmul"]["flops"] \
        == want.by_class()["matmul"]["flops"] > 0

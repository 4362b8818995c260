"""The rounding scheme of the tensor-core K4 (``csrc/ssd_scan.cu``),
emulated in plain PyTorch on the CPU, against the same math in f64.

On the card every product of K4 runs on bf16 tensor cores with f32
accumulation.  s = C Bᵀ takes the bf16 inputs as they are; the f32 operands,
M = s∘G∘dt_j of y = M x and w∘x (w_j = exp(cs_last - cs_j) dt_j) of the state
Bᵀ (w∘x), are split into hi = bf16(v) and lo = bf16(v - hi), and each
product runs for hi and for lo against the same bf16 operand.  The f32
instance (f32 inputs) splits its inputs too and sums hi·hi + hi·lo + lo·hi.
Below the diagonal 64 x 64 tile G = a_i b_j (a_i = exp(cs_i - c), b_j =
exp(c - cs_j), c = cs at the last row of tile j), on and above it G =
exp(cs_i - cs_j) where j <= i; a head whose cs rises somewhere (dt * A > 0
on a row) takes exp(cs_i - cs_j) everywhere, as the kernel does.  The
emulation (``tests/_ssd_split.py``) makes the same splits and factors, and
each product is an f32 matmul of bf16-valued tensors (exact products, f32
sums), here at mamba2-1.3b's and zamba2-1.2b's chunk shapes (Q 256, P 64,
N 128 and 64; B and C shared by the heads or not) with the reference
test's dt and A.  The result is held within K4's tolerance against its
plain version (the cuda tests' and ``chip_smoke.py``'s), here against f64: y
within 2e-2 + 2e-2|f64| in bf16 and 1e-3 + 1e-3|f64| in f32, the states and
gamma within 1e-3 + 1e-3|f64|.  So the scheme is shown to fit that
tolerance without the card.  A single rounding of M and w∘x to bf16 is
shown not to, and so is the limit of the scheme outside the
factorization's precondition: where cs rises over a whole chunk (A > 0)
y in bf16 still holds, y from f32 inputs does not.
"""
import pytest
import torch

from _ssd_split import (fwd_emulated, fwd_exact, fwd_share, inputs, one,
                        one_torch_thread, rising_inputs)  # noqa: F401


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("N", [128, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_scheme_holds_the_k4_tolerance(dtype, N, shared):
    args = inputs(30 + N, dtype, N=N, shared=shared)
    got = fwd_emulated(*args)
    assert all(torch.isfinite(g).all() for g in got)
    assert got[0].dtype == dtype
    assert fwd_share(got, fwd_exact(*args), dtype) <= 1.0


def test_split_scheme_at_a_ragged_chunk():
    """Q 100 (a ragged second tile), P 16, N 16, f32: the emulation and the
    f64 math agree within the tolerance; so does the plain version."""
    from repro_torch.kernels import ssd_scan as ssd
    args = inputs(3, torch.float32, Q=100, H=2, P=16, N=16)
    exact = fwd_exact(*args)
    assert fwd_share(fwd_emulated(*args), exact, torch.float32) <= 1.0
    assert fwd_share(ssd.ssd_chunk_plain(*args), exact, torch.float32) <= 1.0


def test_single_bf16_rounding_of_m_does_not_hold():
    """Why K4 splits: M and w∘x rounded once to bf16 leave the f32 outputs
    (y from f32 inputs, and the states) outside the tolerance at
    mamba2-1.3b's chunk shape."""
    args = inputs(31, torch.float32)
    exact = fwd_exact(*args)
    got = fwd_emulated(*args, m_split=one)
    y_share = fwd_share((got[0], exact[1], exact[2]), exact, torch.float32)
    states_share = fwd_share((exact[0], got[1], exact[2]), exact,
                             torch.float32)
    assert max(y_share, states_share) > 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_scheme_where_cs_rises_over_the_chunk(dtype):
    """Outside the factorization's precondition (heads 1 and 3 with A > 0,
    so cs rises over the whole chunk and exp(cs_i - cs_j) > 1), where the
    kernel takes exp(cs_i - cs_j) per entry: every output is finite and the
    states hold their tolerance; y holds in bf16, but from f32 inputs the
    ~16 bits that hi + lo keep of C, B, M and x reach past y's 1e-3 (the
    plain f32 version stays far inside it).  With A < 0 of the same size
    the scheme holds (test above and the cuda tests)."""
    from repro_torch.kernels import ssd_scan as ssd
    args = rising_inputs(dtype)
    exact = fwd_exact(*args)
    got = fwd_emulated(*args)
    assert all(torch.isfinite(g).all() for g in got)
    y_share = fwd_share((got[0], exact[1], exact[2]), exact, dtype)
    rest = fwd_share((exact[0].to(dtype), got[1], got[2]), exact, dtype)
    assert rest <= 1.0
    if dtype == torch.bfloat16:
        assert y_share <= 1.0
    else:
        assert y_share > 1.0
        plain = ssd.ssd_chunk_plain(*args)
        assert fwd_share(plain, exact, dtype) <= 0.2

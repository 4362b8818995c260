"""What the precision tests of the tensor-core SSD kernels share: their
inputs, the hi/lo bf16 split of an f32 operand, a product as the tensor
cores run it, and the forward kernel's (K4's) arithmetic emulated in plain
PyTorch beside the same math in f64.

On the card every product of K4 and K5 runs on bf16 tensor cores with f32
accumulation.  An f32 operand is split into hi = bf16(v) and lo = bf16(v -
hi), and its product runs for hi and for lo against the same bf16 operand;
with f32 inputs both sides are split and the product sums hi·hi + hi·lo +
lo·hi.  Here each product is an f32 matmul of bf16-valued tensors (exact
products, f32 sums).  Used by ``test_torch_ssd_fwd_precision.py``,
``test_torch_ssd_bwd_precision.py`` and, on the card,
``test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

TILE = 64
FWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}   # K4's y
FWD_F32_TOL = 1e-3                                      # K4's states, gamma


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module's tests (a test run spreads its
    files over worker processes already)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed, dtype, B=1, nc=2, Q=256, H=3, P=64, N=128, shared=True,
           cotangents=False):
    """The reference test's distributions in the (B, nc, Q, H, .) layout:
    x ~ N(0,1), dt = softplus(N(0,1)), A = -exp(0.5 N(0,1)), B, C ~ 0.5
    N(0,1), shared by the heads or per head; with ``cotangents`` also dy ~
    N(0,1) in x's dtype and dS, dg ~ N(0,1) in f32, drawn after them."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    x = t(B, nc, Q, H, P).to(dtype)
    dt = torch.nn.functional.softplus(t(B, nc, Q, H)).to(dtype)
    A = -torch.exp(0.5 * t(H))
    heads = 1 if shared else H
    Bm, Cm = ((0.5 * t(B, nc, Q, heads, N)).to(dtype).expand(B, nc, Q, H, N)
              for _ in range(2))
    if not cotangents:
        return x, dt, A, Bm, Cm
    dy = t(B, nc, Q, H, P).to(dtype)
    return x, dt, A, Bm, Cm, dy, t(B, nc, H, N, P), t(B, nc, H)


# A outside K4's factorization's precondition: heads 1 and 3 with A > 0, so
# cs rises over the whole chunk
RISING_A = (-0.5, 0.002, -0.3, 0.005)


def rising_inputs(dtype):
    """inputs() at B 2, H 4 (mamba2-1.3b's chunk shape otherwise) with A =
    RISING_A"""
    args = list(inputs(5, dtype, B=2, H=4))
    args[2] = torch.tensor(RISING_A)
    return args


def split(v):
    """(hi, lo) = (bf16(v), bf16(v - hi)) as f32 tensors"""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def one(v):
    """a single rounding to bf16 in place of the hi/lo split"""
    return v.bfloat16().float(), torch.zeros_like(v)


def prod(a, b, a_split=None, b_split=None):
    """a @ b as the tensor cores run it: each side that has a split
    function is split into (hi, lo), and the sum is hi·hi + lo·hi + hi·lo
    (no lo·lo)."""
    a_hi, a_lo = a_split(a) if a_split else (a, None)
    b_hi, b_lo = b_split(b) if b_split else (b, None)
    out = a_hi @ b_hi
    if a_lo is not None:
        out = out + a_lo @ b_hi
    if b_lo is not None:
        out = out + a_hi @ b_lo
    return out


def worst_share(got, exact, allowed):
    """The largest |got - exact| / allowed(k, exact) over the outputs
    (``allowed`` gets the output's index and its f64 values, in numpy)."""
    worst = 0.0
    for k, (g, e) in enumerate(zip(got, exact)):
        g, e = g.double().cpu().numpy(), e.double().cpu().numpy()
        worst = max(worst, float((np.abs(g - e) / allowed(k, e)).max()))
    return worst


def fwd_share(got, exact, dtype):
    """The largest |err| / (tol + tol|f64|) over K4's outputs (y, states,
    gamma), y at its dtype's tolerance."""
    tols = (FWD_TOL[dtype], FWD_F32_TOL, FWD_F32_TOL)
    return worst_share(got, exact, lambda k, e: tols[k] * (1 + np.abs(e)))


def fwd_emulated(x, dt, A, Bm, Cm, m_split=split):
    """K4's arithmetic on the card, product by product: (y in x's dtype,
    states (B,nc,H,N,P), gamma (B,nc,H)).  ``m_split`` makes the (hi, lo)
    pair of M and w∘x.  Below the diagonal 64 x 64 tile G = a_i b_j (a_i =
    exp(cs_i - c), b_j = exp(c - cs_j), c = cs at the last row of tile j),
    on and above it G = exp(cs_i - cs_j) where j <= i; a head whose cs rises
    somewhere (dt * A > 0 on a row) takes exp(cs_i - cs_j) everywhere, as
    the kernel does."""
    inp = split if x.dtype == torch.float32 else None
    cell = lambda t: t.float().transpose(2, 3)      # noqa: E731  (B,nc,H,Q,.)
    xf, dtf, Bf, Cf = (cell(t) for t in (x, dt, Bm, Cm))
    Q = x.shape[2]
    cs = torch.cumsum(dtf * A.float()[:, None], dim=-1)          # (B,nc,H,Q)
    s = prod(Cf, Bf.transpose(-1, -2), inp, inp)
    q = torch.arange(Q)
    tile = q // TILE
    c_end = cs[..., torch.clamp((tile + 1) * TILE, max=Q) - 1]    # c of q's tile
    a = torch.exp(cs[..., :, None] - c_end[..., None, :])
    bdt = torch.exp(c_end - cs) * dtf
    falls = (dtf * A.float()[:, None] <= 0).all(-1)[..., None, None]
    below = (tile[:, None] > tile[None, :]) & falls
    direct = torch.where(q[None, :] <= q[:, None],
                         s * torch.exp(cs[..., :, None] - cs[..., None, :])
                         * dtf[..., None, :], 0.0)
    M = torch.where(below, s * a * bdt[..., None, :], direct)
    y = prod(M, xf, m_split, inp)
    # the state Bᵀ (w∘x): B (the bf16 operand) against w∘x split
    w = torch.exp(cs[..., -1:] - cs) * dtf
    x_eff = sum(split(xf)) if inp else xf
    states = prod(Bf.transpose(-1, -2), w[..., None] * x_eff, inp, m_split)
    gamma = torch.exp(cs[..., -1])
    return y.transpose(2, 3).to(x.dtype), states, gamma


def fwd_exact(x, dt, A, Bm, Cm):
    """K4's function in f64."""
    Q = x.shape[2]
    xd, dtd, Bd, Cd = (t.double() for t in (x, dt, Bm, Cm))
    cs = torch.cumsum(dtd * A.double(), dim=2)                   # (B,nc,Q,H)
    csh = cs.transpose(2, 3)
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    G = torch.where(tril, torch.exp(csh[..., :, None] - csh[..., None, :]), 0.0)
    M = torch.einsum("bcihn,bcjhn->bchij", Cd, Bd) * G \
        * dtd.transpose(2, 3)[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", M, xd)
    w = torch.exp(cs[:, :, -1:] - cs) * dtd
    states = torch.einsum("bcjhn,bcjhp->bchnp", Bd * w[..., None], xd)
    return y, states, torch.exp(cs[:, :, -1])

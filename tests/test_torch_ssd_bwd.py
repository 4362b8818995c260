"""K5, the SSD intra-chunk backward, and the gradients of ``ops.ssd_scan``:
the port against the JAX package.

``ssd_chunk_bwd_plain`` (what a CPU tensor gets) is held against the Pallas
backward ``ssd_chunk_bwd_pallas`` in interpret mode at 1e-4 mixed (|err| <=
1e-4 + 1e-4|want|; both in f32 from the same inputs, summation order
differs).  The gradients of the port's ``ops.ssd_scan`` (K4 + K5 through
the autograd Function, the inter-chunk recurrence through torch autograd)
are held against ``jax.grad`` of the reference's ``ops.ssd_scan`` (its
custom VJP over the Pallas backward) and of the sequential oracle
``ref.ssd_ref`` at 2e-4, the reference's own gradient tolerance, with
head-broadcast B/C and an ``initial_state``.  ``apply_mamba`` through the
kernel path is held against the chunked path, forward and gradient, at 5e-3
(the reference's test_kernels.py:168).  Inputs are made with numpy from a
seed with the reference test's distributions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk_bwd_pallas
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm

BWD_TOL = 1e-4
GRAD_TOL = 2e-4
MAMBA_TOL = 5e-3
GRID = [  # (B, L, H, P, N, chunk): the reference's grid, then ragged chunks
    (2, 64, 2, 16, 16, 16), (2, 128, 4, 32, 32, 32), (2, 96, 2, 16, 8, 32),
    (1, 48, 3, 8, 16, 48), (1, 100, 2, 16, 8, 80)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster, and the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, L, H, P, N, heads_bc=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    hb = H if heads_bc is None else heads_bc
    Bm = (0.5 * rng.standard_normal((B, L, hb, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, L, hb, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,L,H,P,N,Q", [
    (2, 64, 2, 16, 16, 16), (2, 128, 4, 32, 32, 32), (2, 64, 2, 16, 8, 32),
    (1, 48, 3, 8, 16, 48), (1, 40, 2, 16, 8, 40)])  # Q not a power of 2
def test_bwd_plain_matches_pallas_interpret(B, L, H, P, N, Q):
    x, dt, A, Bm, Cm = _inputs(0, B, L, H, P, N)
    nc = L // Q
    rng = np.random.default_rng(1)
    dy = rng.standard_normal((B, nc, Q, H, P), dtype=np.float32)
    dst = rng.standard_normal((B, nc, H, N, P), dtype=np.float32)
    dg = rng.standard_normal((B, nc, H), dtype=np.float32)
    ch = lambda a: a.reshape(B, nc, Q, *a.shape[2:])  # noqa: E731
    xc, dtc, Bc, Cc = ch(x), ch(dt), ch(Bm), ch(Cm)

    def flat(a):        # (B,nc,Q,H,.) -> the reference's (B, nc*H, Q, .)
        a = np.moveaxis(a, 3, 2)
        return a.reshape(B, nc * H, Q, *a.shape[4:])

    want = ssd_chunk_bwd_pallas(
        *(jnp.asarray(a) for a in (flat(xc), flat(dtc[..., None])[..., 0],
                                   np.tile(A, nc), flat(Bc), flat(Cc),
                                   flat(dy), dst.reshape(B, nc * H, N, P),
                                   dg.reshape(B, nc * H))), interpret=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = ssd.ssd_chunk_bwd(t(xc), t(dtc), t(A), t(Bc), t(Cc), t(dy), t(dst),
                            t(dg))
    for name, g, w in zip(("dx", "ddt", "dB", "dC"), got, want):
        assert g.dtype == torch.float32, name
        g = g.numpy()
        g = np.moveaxis(g, 3, 2).reshape(np.asarray(w).shape)
        _close(g, w, BWD_TOL)
    _close(got[4].reshape(B, nc * H), want[4], BWD_TOL)


def test_bwd_plain_keeps_bf16_dx_and_f32_rest():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _inputs(2, 1, 32, 2, 8, 4))
    ch = lambda a: a.reshape(1, 2, 16, *a.shape[2:]).bfloat16()  # noqa: E731
    dy = torch.randn(1, 2, 16, 2, 8).bfloat16()
    out = ssd.ssd_chunk_bwd(ch(x), ch(dt), A, ch(Bm), ch(Cm), dy,
                            torch.randn(1, 2, 2, 4, 8), torch.randn(1, 2, 2))
    assert out[0].dtype == torch.bfloat16
    assert all(o.dtype == torch.float32 for o in out[1:])


def _torch_grads(xs, chunk, init, cot):
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
          for a in xs]
    x, dt, A, Bm, Cm = ts
    H = x.shape[2]
    Bh, Ch = (t.expand(-1, -1, H, -1) if t.shape[2] == 1 else t
              for t in (Bm, Cm))
    s0 = None if init is None else torch.from_numpy(init).requires_grad_(True)
    y, s = ops.ssd_scan(x, dt, A, Bh, Ch, chunk=chunk, initial_state=s0)
    loss = (y * torch.from_numpy(cot[0])).sum() + \
        (s * torch.from_numpy(cot[1])).sum()
    loss.backward()
    return [t.grad.numpy() for t in ts] + \
        ([] if s0 is None else [s0.grad.numpy()])


def _jax_grads(fn, xs, init, cot):
    H = xs[0].shape[2]

    def loss(x, dt, A, Bm, Cm, s0=None):
        Bh, Ch = (jnp.broadcast_to(t, t.shape[:2] + (H, t.shape[3]))
                  for t in (Bm, Cm))
        y, s = fn(x, dt, A, Bh, Ch, s0)
        return (y * cot[0]).sum() + (s * cot[1]).sum()

    args = [jnp.asarray(a) for a in xs] + ([] if init is None
                                           else [jnp.asarray(init)])
    return [np.asarray(g) for g in
            jax.grad(loss, argnums=tuple(range(len(args))))(*args)]


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("B,L,H,P,N,chunk", GRID)
def test_ssd_scan_grads_match_reference(B, L, H, P, N, chunk, with_init):
    """Gradients of every input (B and C head-broadcast from one group)
    against jax.grad of the reference's ops.ssd_scan and of ref.ssd_ref."""
    xs = _inputs(3, B, L, H, P, N, heads_bc=1)
    rng = np.random.default_rng(4)
    init = (rng.standard_normal((B, H, P, N)).astype(np.float32)
            if with_init else None)
    cot = (rng.standard_normal((B, L, H, P)).astype(np.float32),
           rng.standard_normal((B, H, P, N)).astype(np.float32))
    got = _torch_grads(xs, chunk, init, cot)
    want_ops = _jax_grads(
        lambda x, dt, A, Bm, Cm, s0: jops.ssd_scan(
            x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0), xs, init, cot)
    want_ref = _jax_grads(
        lambda x, dt, A, Bm, Cm, s0: jref.ssd_ref(
            x, dt, A, Bm, Cm, initial_state=s0), xs, init, cot)
    names = ("x", "dt", "A", "B", "C", "initial_state")
    for name, g, wo, wr in zip(names, got, want_ops, want_ref):
        assert g.shape == wo.shape, name
        _close(g, wo, GRAD_TOL)
        _close(g, wr, GRAD_TOL)


def test_ssd_scan_backward_launches_no_kernel_on_cpu():
    xs = [torch.from_numpy(a).requires_grad_(True)
          for a in _inputs(5, 1, 40, 2, 8, 4)]
    f0, b0 = ssd.ssd_chunk.launches, ssd.ssd_chunk_bwd.launches
    y, _ = ops.ssd_scan(*xs, chunk=16)
    y.sum().backward()
    assert all(t.grad is not None for t in xs)
    assert (ssd.ssd_chunk.launches, ssd.ssd_chunk_bwd.launches) == (f0, b0)


def test_backward_takes_the_bwd_function_not_autograd_of_the_plain(
        monkeypatch):
    """The CPU backward goes through ssd_chunk_bwd, as CUDA tensors do."""
    calls = []
    real = ssd.ssd_chunk_bwd_plain

    def spy(*a):
        calls.append(a[5].dtype)
        return real(*a)

    monkeypatch.setattr(ssd, "ssd_chunk_bwd_plain", spy)
    x, dt, A, Bm, Cm = (torch.from_numpy(a).bfloat16().requires_grad_(True)
                        for a in _inputs(6, 1, 32, 2, 8, 4))
    y, s = ops.ssd_scan(x, dt, A.float(), Bm, Cm, chunk=16)
    (y.float().sum() + s.float().sum()).backward()
    assert calls == [torch.bfloat16]       # dy rounded to x's dtype
    assert x.grad.dtype == dt.grad.dtype == Bm.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_apply_mamba_kernel_matches_chunked_fwd_and_grad(arch):
    cfg = reduced_config(ARCHS[arch])
    from repro_torch.models.lm import build_model
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    lp = {k: v[0].clone().requires_grad_(True)
          for k, v in params["layers"]["mamba"].items()}
    x_in = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 40, cfg.d_model), dtype=np.float32))
    out, grads = {}, {}
    for impl in ("chunked", "kernel"):
        y, _ = ssm.apply_mamba(lp, x_in, cfg, mode="train", impl=impl)
        out[impl] = y.detach().numpy()
        grads[impl] = torch.autograd.grad((y * y).sum(), list(lp.values()))
    _close(out["kernel"], out["chunked"], MAMBA_TOL)
    for name, gk, gc in zip(lp, grads["kernel"], grads["chunked"]):
        _close(gk.numpy(), gc.numpy(), MAMBA_TOL)

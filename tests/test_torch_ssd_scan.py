"""K4, the SSD intra-chunk pass, and ``ops.ssd_scan``: the port against the
JAX package.

The port's ``ssd_chunk`` on CPU tensors (its plain version) is held against
the Pallas kernel ``ssd_chunk_pallas`` run in interpret mode at 1e-5 (both
compute in f32 from the same inputs; only the summation order differs).
``ops.ssd_scan`` is held against the reference's ``ops.ssd_scan`` and its
sequential oracle ``ref.ssd_ref`` at 2e-3, the reference's own tolerance,
over the grid of the reference's kernel test.  Inputs are made with numpy
from a seed, with the reference test's distributions.  The CUDA kernel's own
tests are in test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as ssd

GRID = [  # (L, H, P, N, chunk): the reference's kernel-test grid
    (64, 2, 16, 16, 16), (128, 4, 32, 32, 32), (96, 2, 16, 8, 32)]
SCAN_TOL = 2e-3
CHUNK_TOL = 1e-5


def _inputs(seed, B, L, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, L, H, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, L, H, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


def _chunked(xs, Q):
    x, dt, A, Bm, Cm = xs
    B, L = x.shape[:2]
    nc = L // Q
    return (x.reshape(B, nc, Q, *x.shape[2:]), dt.reshape(B, nc, Q, -1), A,
            Bm.reshape(B, nc, Q, *Bm.shape[2:]),
            Cm.reshape(B, nc, Q, *Cm.shape[2:]))


def _t(xs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in xs]


def _j(xs):
    return [jnp.asarray(a) for a in xs]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("L,Q,H,P,N", [
    (64, 16, 2, 16, 16), (128, 32, 4, 32, 32), (64, 32, 2, 16, 8),
    (48, 48, 3, 8, 16)])                       # one chunk, Q not a power of 2
def test_chunk_plain_matches_pallas_interpret(L, Q, H, P, N):
    xs = _chunked(_inputs(0, 2, L, H, P, N), Q)
    want = ssd_chunk_pallas(*_j(xs), interpret=True)
    got = ssd.ssd_chunk(*_t(xs))
    names = ("y_diag", "states", "gamma")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == w.shape, name
        assert g.dtype == torch.float32, name
        _close(g, w, CHUNK_TOL)


def test_chunk_plain_bf16_keeps_f32_states():
    xs = _chunked(_inputs(1, 1, 32, 2, 16, 8), 16)
    t = _t(xs)
    args = [a.bfloat16() if a.dim() > 1 else a for a in t]
    y, states, gamma = ssd.ssd_chunk(*args)
    assert y.dtype == torch.bfloat16
    assert states.dtype == gamma.dtype == torch.float32
    want = ssd.ssd_chunk_plain(*[a.float() if a.dim() > 1 else a
                                 for a in args])
    _close(y.float(), want[0], 2e-2)
    _close(states, want[1], 1e-5)


def test_chunk_plain_masks_by_selection_not_multiplication():
    """Large |dt*A| makes exp(cs_i - cs_j) overflow above the diagonal; the
    result must stay finite (inf * 0 would be NaN)."""
    x, dt, A, Bm, Cm = _inputs(2, 1, 32, 2, 8, 8)
    dt = dt * 50.0
    got = ssd.ssd_chunk(*_t(_chunked((x, dt, A, Bm, Cm), 32)))
    assert all(torch.isfinite(g).all() for g in got)


@pytest.mark.parametrize("L,H,P,N,chunk", GRID)
def test_ssd_scan_matches_reference_and_sequential_oracle(L, H, P, N, chunk):
    xs = _inputs(3, 2, L, H, P, N)
    want_y, want_s = jops.ssd_scan(*_j(xs), chunk=chunk)
    ref_y, ref_s = jref.ssd_ref(*_j(xs))
    got_y, got_s = ops.ssd_scan(*_t(xs), chunk=chunk)
    assert got_y.shape == (2, L, H, P) and got_s.shape == (2, H, P, N)
    for g, w in ((got_y, want_y), (got_s, want_s), (got_y, ref_y),
                 (got_s, ref_s)):
        _close(g, w, SCAN_TOL)


@pytest.mark.parametrize("L,H,P,N", [(37, 2, 16, 8), (5, 3, 8, 4)])
def test_port_oracle_matches_reference_oracle(L, H, P, N):
    xs = _inputs(4, 2, L, H, P, N)
    s0 = np.random.default_rng(5).standard_normal((2, H, P, N)).astype(
        np.float32)
    for init in (None, s0):
        want = jref.ssd_ref(*_j(xs), initial_state=None if init is None
                            else jnp.asarray(init))
        got = tref.ssd_ref(*_t(xs), initial_state=None if init is None
                           else torch.from_numpy(init))
        for g, w in zip(got, want):
            _close(g, w, 1e-5)


def test_ssd_scan_initial_state_split():
    """Scan over [x1; x2] == scan x1, then x2 from its state (the reference's
    test, with the split off a chunk boundary)."""
    x, dt, A, Bm, Cm = _t(_inputs(6, 1, 64, 2, 16, 16))
    A = -torch.ones(2)
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    y1, s1 = ops.ssd_scan(x[:, :40], dt[:, :40], A, Bm[:, :40], Cm[:, :40],
                          chunk=16)
    y2, s2 = ops.ssd_scan(x[:, 40:], dt[:, 40:], A, Bm[:, 40:], Cm[:, 40:],
                          chunk=16, initial_state=s1)
    _close(torch.cat([y1, y2], 1), y, SCAN_TOL)
    _close(s2, s, SCAN_TOL)
    jy2, js2 = jops.ssd_scan(*_j([a.numpy() for a in (x[:, 40:], dt[:, 40:],
                                                     A, Bm[:, 40:],
                                                     Cm[:, 40:])]),
                             chunk=16, initial_state=jnp.asarray(s1.numpy()))
    _close(y2, jy2, SCAN_TOL)
    _close(s2, js2, SCAN_TOL)


def test_ssd_scan_broadcast_heads_stay_a_view():
    """B/C shared by the heads as a stride-0 expand give the same result as
    materialized copies, and padding keeps them stride 0 (no copy per head)."""
    x, dt, A, Bm, Cm = _t(_inputs(7, 2, 50, 4, 8, 8))
    Bb = Bm[:, :, :1].expand(-1, -1, 4, -1)
    Cb = Cm[:, :, :1].expand(-1, -1, 4, -1)
    padded = ops._pad_seq(Bb, 14)
    assert padded.shape == (2, 64, 4, 8) and padded.stride(2) == 0
    assert torch.count_nonzero(padded[:, 50:]) == 0
    got = ops.ssd_scan(x, dt, A, Bb, Cb, chunk=16)
    want = ops.ssd_scan(x, dt, A, Bb.contiguous(), Cb.contiguous(), chunk=16)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


def test_cpu_path_launches_no_kernel():
    before = ssd.ssd_chunk.launches
    ops.ssd_scan(*_t(_inputs(8, 1, 20, 2, 8, 4)), chunk=16)
    assert ssd.ssd_chunk.launches == before


def test_rejects_bad_inputs():
    x, dt, A, Bm, Cm = _t(_chunked(_inputs(9, 1, 32, 2, 8, 4), 16))
    with pytest.raises(ValueError):
        ssd.ssd_chunk(x, dt[:, :, :8], A, Bm, Cm)
    with pytest.raises(ValueError):
        ssd.ssd_chunk(x, dt, A[:1], Bm, Cm)
    with pytest.raises(ValueError):
        ssd.ssd_chunk(x, dt, A, Bm, Cm[..., :2])
    with pytest.raises(TypeError):
        ssd.ssd_chunk(x.double(), dt.double(), A, Bm.double(), Cm.double())
    with pytest.raises(TypeError):
        ssd.ssd_chunk(x.bfloat16(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="cpu or cuda"):   # no silent path
        ssd.ssd_chunk(*(t.to("meta") for t in (x, dt, A, Bm, Cm)))

"""Attention cores: the port against the JAX package in f32.

Tolerance 1e-5 (absolute and relative): f32 softmax attention from the same
numpy inputs; the packages differ in summation order only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ja
from repro_torch.models import attention as ta

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, B, sq, sk, H, KVH, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, sq, H, D), dtype=np.float32),
            rng.standard_normal((B, sk, KVH, D), dtype=np.float32),
            rng.standard_normal((B, sk, KVH, D), dtype=np.float32))


def _both(fn_j, fn_t, xs, **kw):
    want = fn_j(*(jnp.asarray(x) for x in xs), **kw)
    got = fn_t(*(torch.from_numpy(x) for x in xs), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 7])
def test_naive_attention(causal, q_offset):
    got, want = _both(ja.naive_attention, ta.naive_attention,
                      _qkv(0, 2, 9, 16, 4, 2, 32), causal=causal,
                      q_offset=q_offset)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("sk,block", [(40, 16), (40, 64), (33, 8)])
def test_blocked_attention(causal, q_offset, sk, block):
    """Sk not a block multiple (40 % 16, 33 % 8) and a q offset."""
    got, want = _both(ja.blocked_attention, ta.blocked_attention,
                      _qkv(1, 2, 12, sk, 8, 2, 32), causal=causal,
                      q_offset=q_offset, block=block)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("length", [1, 9, 24])
def test_decode_attention_partly_filled_cache(length):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 1, 8, 32), dtype=np.float32)
    ck = rng.standard_normal((2, 24, 2, 32), dtype=np.float32)
    cv = rng.standard_normal((2, 24, 2, 32), dtype=np.float32)
    want = ja.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                               jnp.asarray(cv), jnp.asarray(length))
    got = ta.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                              torch.from_numpy(cv), length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # entries at and past `length` do not matter
    ck[:, length:] = 1e3
    got2 = ta.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                               torch.from_numpy(cv), length)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


def test_fully_masked_rows_stay_finite():
    """The finite -1e30 mask: a query row that sees no key (q_offset < 0)
    gives a finite mean of V, never NaN, in both packages alike."""
    got, want = _both(ja.blocked_attention, ta.blocked_attention,
                      _qkv(3, 1, 6, 10, 4, 2, 32), causal=True,
                      q_offset=-3, block=4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)

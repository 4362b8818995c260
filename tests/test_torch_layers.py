"""Shared layers: the port against the JAX package in f32.

Tolerance 1e-6 (absolute and relative): both compute in f32 from the same
numpy inputs and differ only in summation order and transcendental rounding.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    p = {"scale": 1 + 0.1 * rng.standard_normal(64, dtype=np.float32)}
    if kind == "layer":
        p["bias"] = 0.1 * rng.standard_normal(64, dtype=np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xj, xt = _pair(x)
    _close(tl.apply_norm(tp, xt), jl.apply_norm(jp, xj))


@pytest.mark.parametrize("fraction", [0.5, 1.0])
def test_apply_rope_interleaved_pairs(fraction):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32), dtype=np.float32)
    pos = (100 + np.arange(7))[None, :].repeat(2, 0)     # nonzero positions
    xj, xt = _pair(x)
    want = jl.apply_rope(xj, jnp.asarray(pos), fraction, 10_000.0)
    got = tl.apply_rope(xt, torch.from_numpy(pos), fraction, 10_000.0)
    _close(got, want, rtol=1e-5, atol=2e-6)   # sin/cos of angles up to ~1e2
    rot = int(32 * fraction)
    np.testing.assert_array_equal(got[..., rot:].numpy(), x[..., rot:])


def test_rope_freqs_rounds_rot_down_to_even():
    assert tl.rope_freqs(10, 0.35, 10_000.0).shape == (1,)   # int(3.5)=3 -> 2
    assert tl.rope_freqs(4, 0.25, 10_000.0) is None          # 1 -> 0
    _close(tl.rope_freqs(128, 0.5, 10_000.0),
           jl.rope_freqs(128, 0.5, 10_000.0))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "sq_relu", "gelu"])
def test_apply_mlp(kind):
    rng = np.random.default_rng(2)
    d, f = 32, 48
    shapes = ({"wi_gate": (d, f), "wi_up": (d, f), "wo": (f, d)}
              if kind in ("swiglu", "geglu") else {"wi": (d, f), "wo": (f, d)})
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    x = rng.standard_normal((2, 5, d), dtype=np.float32)
    want = jl.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), kind)
    got = tl.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), kind)
    _close(got, want, rtol=1e-5, atol=1e-6)


def test_embed_and_logits():
    cfg = dataclasses.replace(ARCHS["chatglm3-6b"], d_model=16,
                              vocab_size=300)
    rng = np.random.default_rng(3)
    V = cfg.padded_vocab
    p = {"table": rng.standard_normal((V, 16), dtype=np.float32),
         "head": rng.standard_normal((16, V), dtype=np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    toks = rng.integers(0, cfg.vocab_size, size=(2, 6))
    xj = jl.embed_tokens(jp, jnp.asarray(toks), cfg)
    xt = tl.embed_tokens(tp, torch.from_numpy(toks), cfg)
    _close(xt, xj, rtol=0, atol=0)
    _close(tl.logits_from_hidden(tp, xt, cfg),
           jl.logits_from_hidden(jp, xj, cfg), rtol=1e-5, atol=1e-5)

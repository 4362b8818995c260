"""Reduced chatglm3-6b: the port's prefill and decode against the JAX package.

Both packages get the same parameters (the reference's init plus seeded
numpy noise, so QKV biases and norm scales are not 0 and 1) and the same
tokens.  Tolerance in f32: 1e-4 relative, and 1e-4 of the tensor's largest
magnitude absolute (the reference's init draws large weights, so caches and
logits reach ~10): two layers of f32 matmuls from identical inputs, differing
in summation order only.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as j_reduced
from repro.models.lm import build_model as j_build
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import LM, build_model

RTOL = 1e-4
ARCH = "chatglm3-6b"


def perturbed_params(cfg, seed=0):
    """Reference init + seeded noise on every leaf, as a numpy tree."""
    params = j_build(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced(JARCHS[ARCH])
    tcfg = reduced_config(ARCHS[ARCH])
    tree = perturbed_params(jcfg)
    return jcfg, tcfg, tree


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("impl", ["flash", "blocked"])
def test_prefill_then_decode_matches_reference(setup, impl):
    jcfg, tcfg, tree = setup
    jm = j_build(jcfg, attn_impl=impl, kv_block=8)
    tm = build_model(tcfg, attn_impl=impl, kv_block=8)
    tp = params_from_jax(tree, tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, size=(2, 13))

    jl, jc = jax.jit(jm.prefill_fn)(tree, {"tokens": toks})
    tl, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    assert sorted(tc) == sorted(jc) == ["k", "v"]
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape == (
            tcfg.n_layers, 2, 13, tcfg.n_kv_heads, tcfg.head_dim)
        _close(tc[name], jc[name])

    # one decode step at position 13 into caches with room for it
    pad = ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0))
    jcache = {n: np.pad(_np(jc[n]), pad) for n in ("k", "v")}
    tcache = {n: torch.from_numpy(jcache[n].copy()) for n in ("k", "v")}
    nxt = np.argmax(_np(jl), axis=-1)[:, None]
    jl2, jc2 = jax.jit(jm.decode_fn)(tree, jcache,
                                      {"tokens": nxt, "pos": np.int32(13)})
    tl2, tc2 = tm.decode_fn(tp, tcache, {"tokens": torch.from_numpy(nxt),
                                          "pos": 13})
    _close(tl2, jl2)
    for name in ("k", "v"):
        _close(tc2[name], jc2[name])


def test_param_specs_match_reference(setup):
    jcfg, tcfg, tree = setup
    tp = params_from_jax(tree, tcfg, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == len(LM(tcfg).param_specs()["layers"]["attn"]) + 8
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
    from repro.models import params as jpr
    from repro_torch.models import params as tpr
    assert tpr.count(LM(tcfg).param_specs()) \
        == jpr.count(j_build(jcfg).param_specs()) == tcfg.param_count()


def test_init_draws_from_generator():
    cfg = reduced_config(ARCHS[ARCH])
    m = LM(cfg)
    a = m.init(torch.Generator().manual_seed(0))
    b = m.init(torch.Generator().manual_seed(0))
    c = m.init(torch.Generator().manual_seed(1))
    wq = a["layers"]["attn"]["wq"]
    assert torch.equal(wq, b["layers"]["attn"]["wq"])
    assert not torch.equal(wq, c["layers"]["attn"]["wq"])
    # truncated at 2 std, fan-in from one layer's (d, h, hd) shape
    assert wq.abs().max() <= 2.0 / np.sqrt(cfg.d_model) + 1e-6
    assert wq.std() > 0.5 / np.sqrt(cfg.d_model)
    assert torch.equal(a["layers"]["attn"]["bq"], torch.zeros_like(
        a["layers"]["attn"]["bq"]))
    assert torch.equal(a["final_norm"]["scale"], torch.ones(cfg.d_model))

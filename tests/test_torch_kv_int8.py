"""The int8 KV cache and cache sizing against the JAX package.

* ``quantize_kv`` bit for bit: the same int8 values and f16 scales
  (symmetric per-(token, head) scales, round half to even, clamped at 127
  and at a 1e-8 scale for an all-zero row).
* ``decode_fn`` over an int8 cache (reduced qwen1.5-32b, the reference's
  one int8 architecture): the prompt's k/v from the reference's prefill,
  quantized by the reference into both packages' ``init_cache``, then three
  decode steps; logits within 1e-4 relative and 1e-4 of the largest |logit|
  (f32, summation order only); the written cache entries equal but for a
  step of one where a value lands on a rounding half (under 1 %).
* ``decode_attention_q8`` against ``naive_attention`` over the dequantized
  cache (the identity the scales' placement rests on), at 1e-5.
* ``cache_specs``, ``cache_bytes`` and ``kv_token_bytes`` equal to the
  reference's for all ten architectures, bf16 and int8.
* ``ServeEngine.generate`` refuses an int8 model in both packages: prefill
  returns k/v as computed, which do not match the int8 cache's spec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as j_reduced
from repro.models.attention import quantize_kv as j_quantize_kv
from repro.models.lm import build_model as j_build
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.kvcache import cache_bytes as j_cache_bytes
from repro.serve.kvcache import kv_token_bytes as j_kv_token_bytes
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models.attention import (decode_attention_q8,
                                          naive_attention, quantize_kv)
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import cache_bytes, kv_token_bytes
from _families import perturbed_params

ARCH = "qwen1.5-32b"
RTOL = 1e-4
B, S, SMAX, DECODE_STEPS = 2, 11, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.mark.parametrize("shape,scale", [((3, 17, 4, 32), 1.0),
                                         ((2, 5, 2, 128), 40.0),
                                         ((1, 64, 8, 64), 1e-3)])
def test_quantize_kv_bit_identical(shape, scale):
    rng = np.random.default_rng(sum(shape))
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    x[0, 0, 0] = 0.0                                 # the 1e-8 floor
    x[0, 1, 0, :4] = [127.0, 63.5, -0.5, 1.5]        # halves: to even
    jq, js = jax.jit(j_quantize_kv)(x)     # the reference as it runs: jitted
    tq, ts = quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int16),
                                  np.asarray(js).view(np.int16))
    # bf16 inputs (the card's caches) as well
    xb = torch.from_numpy(x).bfloat16()
    jq, js = jax.jit(j_quantize_kv)(jnp.asarray(xb.float().numpy(),
                                                jnp.bfloat16))
    tq, ts = quantize_kv(xb)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int16),
                                  np.asarray(js).view(np.int16))


def test_decode_attention_q8_is_attention_over_the_dequantized_cache():
    gen = torch.Generator().manual_seed(0)
    Bq, Sm, H, KVH, D, length = 2, 24, 8, 2, 64, 19
    q = torch.randn((Bq, 1, H, D), generator=gen)
    k, v = (torch.randn((Bq, Sm, KVH, D), generator=gen) for _ in range(2))
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    got = decode_attention_q8(q, kq, vq, ks, vs, length)
    deq_k = kq.float() * ks.float()[..., None]
    deq_v = vq.float() * vs.float()[..., None]
    want = naive_attention(q, deq_k[:, :length], deq_v[:, :length],
                           causal=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_int8_decode_matches_reference():
    jcfg, tcfg = j_reduced(JARCHS[ARCH]), reduced_config(ARCHS[ARCH])
    tree = perturbed_params(jcfg)
    tp = params_from_jax(tree, tcfg, device="cpu")
    jm = j_build(jcfg, kv_cache_dtype="int8")
    tm = build_model(tcfg, kv_cache_dtype="int8")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, size=(B, S))

    # the prompt's k/v from the reference's prefill, quantized into the cache
    jl, jc = jax.jit(jm.prefill_fn)(tree, {"tokens": toks})
    cache = {n: np.array(a) for n, a in jm.init_cache(B, SMAX).items()}
    for name in ("k", "v"):
        qv, sc = jax.jit(j_quantize_kv)(jc[name])
        cache[name][:, :, :S] = np.asarray(qv)
        cache[f"{name}_scale"][:, :, :S] = np.asarray(sc)
    tcache = tm.init_cache(B, SMAX, device="cpu")
    assert {n: (tuple(t.shape), t.dtype) for n, t in tcache.items()} == {
        n: (a.shape, {np.dtype(np.int8): torch.int8,
                      np.dtype(np.float16): torch.float16}[a.dtype])
        for n, a in cache.items()}
    for n, a in cache.items():
        tcache[n].copy_(torch.from_numpy(a))

    decode = jax.jit(jm.decode_fn)
    jcache = cache
    nxt = np.argmax(np.asarray(jl), axis=-1)[:, None]
    for i in range(DECODE_STEPS):
        jl2, jcache = decode(tree, jcache, {"tokens": nxt,
                                            "pos": np.int32(S + i)})
        tl2, tcache = tm.decode_fn(tp, tcache, {
            "tokens": torch.from_numpy(nxt), "pos": S + i})
        want = np.asarray(jl2)
        np.testing.assert_allclose(_np(tl2), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
        nxt = np.argmax(want, axis=-1)[:, None]
    for name in ("k", "v", "k_scale", "v_scale"):
        got, want = _np(tcache[name]), np.asarray(jcache[name])
        assert got.dtype == want.dtype
        # the decoded tokens' entries: the same int8 values (a value at a
        # rounding half may step by one) and scales within f16's rounding
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32),
                                   rtol=1e-3, atol=1 if "scale" not in name
                                   else 1e-3 * np.abs(want).max())
        assert (got != want).mean() < 1e-2, name


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_and_bytes_equal_reference(arch):
    for kv_dtype in ("bf16", "int8"):
        jm = j_build(JARCHS[arch], kv_cache_dtype=kv_dtype)
        tm = build_model(ARCHS[arch], kv_cache_dtype=kv_dtype)
        js = jax.tree.leaves(jm.cache_specs(2, 333), is_leaf=lambda p: hasattr(
            p, "axes"))
        ts = [p for p in jax.tree.leaves(tm.cache_specs(2, 333),
                                         is_leaf=lambda p: hasattr(p, "axes"))]
        assert [(p.shape, p.axes, p.dtype) for p in ts] \
            == [(p.shape, p.axes, p.dtype) for p in js]
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            for batch, seq in ((1, 1), (2, 333), (16, 32_768)):
                assert cache_bytes(tm, batch, seq, tdt) \
                    == j_cache_bytes(jm, batch, seq, jdt)
            assert kv_token_bytes(tm, tdt) == j_kv_token_bytes(jm, jdt)
    if arch == ARCH:   # per token per layer: 10,240 + 160 vs 20,480 bytes
        cfg = ARCHS[arch]
        per_layer = {d: kv_token_bytes(build_model(cfg, kv_cache_dtype=d))[0]
                     / cfg.n_layers for d in ("int8", "bf16")}
        assert per_layer == {"int8": 10_400, "bf16": 20_480}


def test_generate_refuses_an_int8_cache_as_the_reference_does():
    jcfg, tcfg = j_reduced(JARCHS[ARCH]), reduced_config(ARCHS[ARCH])
    tree = perturbed_params(jcfg)
    prompts = [[1, 2, 3, 4]]
    with pytest.raises(ValueError):
        JServeEngine(j_build(jcfg, kv_cache_dtype="int8"), tree,
                     max_seq=8).generate(prompts, max_new_tokens=2)
    with pytest.raises(ValueError, match="tree structures differ"):
        ServeEngine(build_model(tcfg, kv_cache_dtype="int8"),
                    params_from_jax(tree, tcfg, device="cpu"), max_seq=8,
                    device="cpu").generate(prompts, max_new_tokens=2)


def test_unknown_kv_cache_dtype_raises():
    with pytest.raises(ValueError, match="KV cache dtype"):
        build_model(ARCHS[ARCH], kv_cache_dtype="fp8")

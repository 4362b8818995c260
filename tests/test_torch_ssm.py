"""The Mamba2 block (``models/ssm.py``) and ``rms_norm_gated``: the port
against the JAX package.

Same numpy inputs from a seed on both sides, in f32.  Tolerances: 1e-5
relative and 1e-5 of the tensor's largest magnitude absolute for single ops
(conv, segsum, decode step, gated norm: the same arithmetic, rounding order
aside); 1e-4 for the chunked scan and the whole mixer, whose f32 matmuls sum
up to 64 terms in another order.  ``apply_mamba`` runs each port impl
against the reference impl it stands for: ``"chunked"`` against ``"jnp"``,
``"kernel"`` against ``"pallas"`` (the Pallas kernel in interpret mode, the
port's plain version of K4 on the CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as j_reduced
from repro.models import layers as jl
from repro.models import ssm as jssm
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models import layers as tl
from repro_torch.models import ssm as tssm

IMPLS = {"chunked": "jnp", "kernel": "pallas"}


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _cfgs(arch="mamba2-1.3b"):
    return j_reduced(JARCHS[arch]), reduced_config(ARCHS[arch])


def _mamba_tree(jcfg, seed):
    """Reference spec shapes, seeded numpy values: inits where they keep the
    block stable (A_log, dt_bias, norm), noise elsewhere."""
    rng = np.random.default_rng(seed)
    specs = jssm.mamba_params(jcfg)
    out = {}
    for name, p in specs.items():
        if p.init == "a_log":
            v = np.log(rng.uniform(1, 16, p.shape))
        elif p.init == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), p.shape))
            v = dt + np.log(-np.expm1(-dt))
        elif p.init in ("ones", "zeros"):
            v = float(p.init == "ones") + 0.1 * rng.standard_normal(p.shape)
        else:
            fan_in = p.shape[-1] if p.init == "conv" else p.shape[0]
            v = rng.standard_normal(p.shape) / np.sqrt(fan_in)
        out[name] = v.astype(np.float32)
    return out


def test_mamba_params_match_reference():
    jcfg, tcfg = _cfgs("zamba2-1.2b")
    jspecs, tspecs = jssm.mamba_params(jcfg), tssm.mamba_params(tcfg)
    assert sorted(jspecs) == sorted(tspecs)
    for name in jspecs:
        j, t = jspecs[name], tspecs[name]
        assert (t.shape, t.axes, t.init, t.scale) \
            == (j.shape, j.axes, j.init, j.scale), name


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_matches_reference(with_cache):
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, 7, 12), dtype=np.float32)
    w = rng.standard_normal((12, 4), dtype=np.float32) / 2
    b = rng.standard_normal(12, dtype=np.float32)
    cache = rng.standard_normal((2, 3, 12), dtype=np.float32) \
        if with_cache else None
    jy, jc = jssm.causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
                              None if cache is None else jnp.asarray(cache))
    ty, tc = tssm.causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                              torch.from_numpy(b),
                              None if cache is None else torch.from_numpy(cache))
    _close(ty, jy, 1e-5)
    _close(tc, jc, 1e-5)


def test_causal_conv_one_token_with_cache_continues_the_sequence():
    """Decoding token by token through the conv cache equals one pass."""
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.standard_normal((1, 6, 5), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 4), dtype=np.float32))
    b = torch.zeros(5)
    full, _ = tssm.causal_conv(u, w, b)
    y, cache = tssm.causal_conv(u[:, :2], w, b)
    steps = [y]
    for t in range(2, 6):
        y, cache = tssm.causal_conv(u[:, t:t + 1], w, b, cache)
        steps.append(y)
    _close(torch.cat(steps, 1), full, 1e-6)


def test_segsum_matches_reference():
    cs = np.cumsum(-np.random.default_rng(2).uniform(0, 1, (2, 3, 9)),
                   axis=-1).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(cs)))
    got = tssm._segsum(torch.from_numpy(cs)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("L,G,chunk,with_init", [
    (64, 1, 16, False), (50, 2, 16, True), (12, 1, 16, False),
    (40, 4, 8, True)])
def test_ssd_chunked_matches_reference(L, G, chunk, with_init):
    rng = np.random.default_rng(3)
    B, H, P, N = 2, 4, 8, 16
    x = rng.standard_normal((B, L, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, L, G, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, L, G, N))).astype(np.float32)
    init = rng.standard_normal((B, H, P, N)).astype(np.float32) \
        if with_init else None
    xs = (x, dt, A, Bm, Cm)
    jy, js = jssm.ssd_chunked(*(jnp.asarray(a) for a in xs), chunk,
                              None if init is None else jnp.asarray(init))
    ty, ts = tssm.ssd_chunked(*(torch.from_numpy(a) for a in xs), chunk,
                              None if init is None else torch.from_numpy(init))
    _close(ty, jy, 1e-4)
    _close(ts, js, 1e-4)


def test_ssd_chunked_bf16_rounds_like_reference():
    """In bf16 the chunked path rounds M and the carried state to bf16 as the
    reference's jnp path does: held at the bf16 tolerance, 2e-2 of max."""
    rng = np.random.default_rng(4)
    B, L, H, P, N = 1, 32, 2, 8, 8
    xs = (rng.standard_normal((B, L, H, P), dtype=np.float32),
          np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32),
          (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32),
          (0.5 * rng.standard_normal((B, L, 1, N))).astype(np.float32),
          (0.5 * rng.standard_normal((B, L, 1, N))).astype(np.float32))
    bf = (True, False, False, True, True)
    jy, js = jssm.ssd_chunked(*(jnp.asarray(a).astype(jnp.bfloat16) if b
                                else jnp.asarray(a) for a, b in zip(xs, bf)), 16)
    ty, ts = tssm.ssd_chunked(*(torch.from_numpy(a).bfloat16() if b
                                else torch.from_numpy(a) for a, b in zip(xs, bf)),
                              16)
    assert ty.dtype == ts.dtype == torch.bfloat16
    _close(ty, jy, 2e-2)
    _close(ts, js, 2e-2)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(5)
    B, H, P, N, G = 2, 4, 8, 16, 2
    args = (rng.standard_normal((B, H, P, N), dtype=np.float32),
            rng.standard_normal((B, H, P), dtype=np.float32),
            np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32),
            (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32),
            rng.standard_normal((B, G, N), dtype=np.float32),
            rng.standard_normal((B, G, N), dtype=np.float32))
    jy, js = jssm.ssd_decode_step(*(jnp.asarray(a) for a in args))
    ty, ts = tssm.ssd_decode_step(*(torch.from_numpy(a) for a in args))
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)


def test_rms_norm_gated_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    g = rng.standard_normal((2, 5, 64), dtype=np.float32)
    s = 1 + 0.1 * rng.standard_normal(64, dtype=np.float32)
    want = jl.rms_norm_gated(jnp.asarray(x), jnp.asarray(s), jnp.asarray(g))
    got = tl.rms_norm_gated(torch.from_numpy(x), torch.from_numpy(s),
                            torch.from_numpy(g))
    _close(got, want, 1e-5)
    assert tl.rms_norm_gated(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(s),
                             torch.from_numpy(g)).dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_apply_mamba_prefill_then_decode_matches_reference(impl):
    """Prefill 21 tokens (two chunks of 16, ragged), then decode two tokens
    against the prefill's cache, each against the reference's impl."""
    jcfg, tcfg = _cfgs()
    tree = _mamba_tree(jcfg, 7)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    tp = {k: torch.from_numpy(v) for k, v in tree.items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 21, tcfg.d_model), dtype=np.float32)
    jout, jc = jssm.apply_mamba(jp, jnp.asarray(x), jcfg, mode="prefill",
                                impl=IMPLS[impl])
    tout, tc = tssm.apply_mamba(tp, torch.from_numpy(x), tcfg, mode="prefill",
                                impl=impl)
    _close(tout, jout, 1e-4)
    assert sorted(tc) == sorted(jc)
    for name in jc:
        _close(tc[name], jc[name], 1e-4)

    tcache = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jc.items()}
    for step in range(2):
        xt = rng.standard_normal((2, 1, tcfg.d_model), dtype=np.float32)
        jout, jc = jssm.apply_mamba(jp, jnp.asarray(xt), jcfg, mode="decode",
                                    cache=jc, impl=IMPLS[impl])
        tout, tcache = tssm.apply_mamba(tp, torch.from_numpy(xt), tcfg,
                                        mode="decode", cache=tcache, impl=impl)
        _close(tout, jout, 1e-4)
        for name in jc:
            _close(tcache[name], jc[name], 1e-4)


def test_apply_mamba_rejects_unknown_impl():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="SSD impl"):
        tssm.apply_mamba({}, torch.zeros(1, 2, tcfg.d_model), tcfg,
                         mode="prefill", impl="pallas")


def test_init_mamba_cache_matches_reference():
    jcfg, tcfg = _cfgs()
    want = jssm.init_mamba_cache(jcfg, 3, jnp.bfloat16)
    got = tssm.init_mamba_cache(tcfg, 3, torch.bfloat16, device="cpu")
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == torch.bfloat16
        assert torch.count_nonzero(got[name]) == 0


def test_kernel_impl_broadcasts_heads_without_a_copy():
    B, S, G, N, H = 2, 5, 1, 8, 6
    t = torch.randn(B, S, G, N)
    h = tssm._heads(t, H)
    assert h.shape == (B, S, H, N) and h.stride(2) == 0
    assert h.data_ptr() == t.data_ptr()
    t2 = torch.randn(B, S, 2, N)
    h2 = tssm._heads(t2, H)
    assert torch.equal(h2, t2.repeat_interleave(H // 2, dim=2))

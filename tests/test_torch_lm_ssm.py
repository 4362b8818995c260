"""Reduced mamba2-1.3b (ssm) and zamba2-1.2b (hybrid): the port's LM and
ServeEngine against the JAX package.

Both packages get the same parameters (the reference's init plus seeded numpy
noise) and the same tokens.  Each port ``ssd_impl`` runs against the
reference impl it stands for (``"chunked"``/``"jnp"``, ``"kernel"``/
``"pallas"``, the Pallas kernels in interpret mode).  Tolerance in f32: 1e-4
relative and 1e-4 of the tensor's largest magnitude absolute, four layers of
f32 matmuls from identical inputs, differing in summation order only.
Greedy ServeEngine tokens must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as j_reduced
from repro.models import params as jpr
from repro.models.lm import build_model as j_build
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.kvcache import cache_bytes as j_cache_bytes
from repro.serve.kvcache import kv_token_bytes as j_kv_token_bytes
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models import params as tpr
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import LM, build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import cache_bytes, kv_token_bytes

RTOL = 1e-4
SSM_ARCHS = ("mamba2-1.3b", "zamba2-1.2b")
IMPLS = {"chunked": "jnp", "kernel": "pallas"}


def perturbed_params(cfg, seed):
    """Reference init + seeded noise on every leaf, as a numpy tree."""
    params = j_build(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


@pytest.fixture(scope="module", params=SSM_ARCHS)
def setup(request):
    arch = request.param
    jcfg = j_reduced(JARCHS[arch])
    tcfg = reduced_config(ARCHS[arch])
    tree = perturbed_params(jcfg, seed=0)
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_prefill_then_decode_matches_reference(setup, impl):
    jcfg, tcfg, tree, tp = setup
    jm = j_build(jcfg, attn_impl="flash", ssd_impl=IMPLS[impl])
    tm = build_model(tcfg, attn_impl="flash", ssd_impl=impl)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, size=(2, 21))

    jl, jc = jax.jit(jm.prefill_fn)(tree, {"tokens": toks})
    tl, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    jflat, tflat = _flat(jc), _flat(tc)
    assert sorted(jflat) == sorted(tflat)
    for name in jflat:
        _close(tflat[name], jflat[name])

    # two decode steps from position 21; the hybrid's shared K/V get room
    def grow(name, a):
        a = _np(a)
        if name.startswith("shared_"):
            a = np.pad(a, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0)))
        return a

    jcache = {n: grow(n, a) for n, a in jflat.items()}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in jcache.items()}

    def nest(flat):
        out = {}
        for n, a in flat.items():
            *path, leaf = n.split("/")
            d = out
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = a
        return out

    jcache, tcache = nest(jcache), nest(tcache)
    nxt = np.argmax(_np(jl), axis=-1)[:, None]
    decode = jax.jit(jm.decode_fn)
    for pos in (21, 22):
        jl2, jcache = decode(tree, jcache, {"tokens": nxt,
                                            "pos": np.int32(pos)})
        tl2, tcache = tm.decode_fn(tp, tcache, {"tokens": torch.from_numpy(nxt),
                                                "pos": pos})
        _close(tl2, jl2)
        jflat, tflat = _flat(jcache), _flat(tcache)
        for name in jflat:
            _close(tflat[name], jflat[name])
        nxt = np.argmax(_np(jl2), axis=-1)[:, None]


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_greedy_tokens_equal_reference(setup, impl):
    jcfg, tcfg, tree, tp = setup
    jm = j_build(jcfg, attn_impl="flash", ssd_impl=IMPLS[impl])
    tm = build_model(tcfg, attn_impl="flash", ssd_impl=impl)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, tcfg.vocab_size, size=n)]
               for n in (4, 17, 33)]           # one chunk, ragged, 3 chunks
    want = JServeEngine(jm, tree, max_seq=40).generate(prompts,
                                                       max_new_tokens=5)
    eng = ServeEngine(tm, tp, max_seq=40, device="cpu")
    got = eng.generate(prompts, max_new_tokens=5)
    assert got == want
    assert [t.prompt_len for t in eng.timings] == [4, 17, 33]


def test_param_specs_match_reference(setup):
    jcfg, tcfg, tree, tp = setup
    jspecs = _flat(j_build(jcfg).param_specs())
    tspecs = _flat(LM(tcfg).param_specs())
    assert sorted(jspecs) == sorted(tspecs) == sorted(_flat(tp))
    for name, j in jspecs.items():
        t = tspecs[name]
        assert (t.shape, t.axes, t.init) == (j.shape, j.axes, j.init), name
    assert tpr.count(LM(tcfg).param_specs()) \
        == jpr.count(j_build(jcfg).param_specs()) == tcfg.param_count()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_full_width_param_count(arch):
    """1,344,052,224 (mamba2-1.3b) and 1,153,696,640 (zamba2-1.2b)."""
    cfg = ARCHS[arch]
    n = tpr.count(LM(cfg).param_specs())
    assert n == cfg.param_count() == {"mamba2-1.3b": 1_344_052_224,
                                      "zamba2-1.2b": 1_153_696_640}[arch]
    assert LM(cfg).n_shared_invocations() == (7 if arch == "zamba2-1.2b"
                                              else 0)


def test_ssm_inits_have_the_reference_ranges():
    """The generators differ, so the inits are held to their distributions:
    A = exp(A_log) in [1, 16), softplus(dt_bias) log-uniform in [1e-3, 1e-1],
    conv weights truncated normal with std 1/sqrt(d_conv)."""
    cfg = ARCHS["mamba2-1.3b"]
    m = build_model(reduced_config(cfg))
    specs = m.param_specs()["layers"]["mamba"]
    gen = torch.Generator().manual_seed(0)
    wide = {"a_log": (48, 4096), "dt_bias": (48, 4096), "conv": (4096, 4)}
    draws = {k: tpr._init_leaf(gen, tpr.P(s, ("layers",) + (None,) * (len(s) - 1)
                                          if k != "conv" else (None, None), k),
                               torch.float32)
             for k, s in wide.items()}
    A = torch.exp(draws["a_log"])
    assert A.min() >= 1.0 and A.max() < 16.0
    assert abs(A.mean().item() - 8.5) < 0.1             # U[1, 16): mean 8.5
    dt = F.softplus(draws["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-4) and dt.max() <= 1e-1 * (1 + 1e-4)
    logdt = torch.log(dt)
    mid = (np.log(1e-3) + np.log(1e-1)) / 2             # log-uniform: mean mid
    assert abs(logdt.mean().item() - mid) < 0.02
    w = draws["conv"]
    assert w.abs().max() <= 2 * 0.5 + 1e-6               # truncated at 2 std
    assert 0.85 * 0.5 * 0.88 < w.std().item() < 1.15 * 0.5 * 0.88
    # the model's own leaves carry those init kinds
    assert specs["A_log"].init == "a_log" and specs["dt_bias"].init \
        == "dt_bias" and specs["conv_x_w"].init == "conv"
    p = m.init(torch.Generator().manual_seed(1))["layers"]["mamba"]
    assert torch.isfinite(p["dt_bias"]).all() and (p["A_log"] >= 0).all()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_cache_bytes_equal_reference(arch):
    jm, tm = j_build(JARCHS[arch]), build_model(ARCHS[arch])
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        for batch, seq in ((1, 1), (2, 333), (16, 32_768)):
            assert cache_bytes(tm, batch, seq, tdt) \
                == j_cache_bytes(jm, batch, seq, jdt)
        assert kv_token_bytes(tm, tdt) == j_kv_token_bytes(jm, jdt)
    per_token, _ = kv_token_bytes(tm)
    if arch == "mamba2-1.3b":
        assert per_token == 0.0        # the SSM state does not grow
    else:                              # 7 invocations x K and V x 32 x 64
        assert per_token == 7 * 2 * 32 * 64 * 2


def test_pad_cache_pads_only_shared_kv(setup):
    jcfg, tcfg, tree, tp = setup
    tm = build_model(tcfg, attn_impl="flash")
    eng = ServeEngine(tm, tp, max_seq=24, device="cpu")
    prompt = list(range(1, tcfg.n_layers + 1))        # len == n_layers
    _, cache = eng._prefill_one(prompt)
    want = tm.cache_specs(1, 24)
    for name, leaf in _flat(cache).items():
        assert tuple(leaf.shape) == _flat(want)[name].shape, name
        if name.startswith("shared_"):
            assert leaf.shape[2] == 24
            assert torch.count_nonzero(leaf[:, :, len(prompt):]) == 0


def test_unknown_ssd_impl_raises():
    with pytest.raises(ValueError, match="SSD impl"):
        LM(ARCHS["mamba2-1.3b"], ssd_impl="pallas")

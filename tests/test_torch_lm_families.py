"""The moe, vlm and audio families against the JAX package at reduced size:
grok-1-314b and llama4-scout-17b-a16e (MoE, top-2 and top-1 with a shared
expert), paligemma-3b (image embeddings in the first positions, gemma's
embedding scale, MQA at D 32) and whisper-large-v3 (encoder over frames,
cross-attention, sinusoidal positions).

Both packages get the same parameters (the reference's init plus seeded
numpy noise) and the same inputs (tokens, image embeddings and frames from
one numpy generator).  Tolerance in f32: 1e-4 relative, and 1e-4 of the
tensor's largest magnitude absolute: the same f32 math from identical
inputs, differing in summation order only (as in test_torch_lm.py).  The
MoE routing is discrete: it agrees because the perturbed router's
probabilities hold no ties.  The reference's flash runs its Pallas kernel
in interpret mode, as its own tests run it; the port's its plain version.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as j_reduced
from repro.models import params as jpr
from repro.models.lm import build_model as j_build
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models import params as tpr
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import LM, build_model
from _families import FAMILY_ARCHS, model_inputs, perturbed_params, to_torch

RTOL = 1e-4
B, S, DECODE_STEPS = 2, 13, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster, and the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def setup(request):
    arch = request.param
    jcfg = j_reduced(JARCHS[arch])
    tcfg = reduced_config(ARCHS[arch])
    tree = perturbed_params(jcfg)
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def test_param_specs_match_reference(setup):
    jcfg, tcfg, tree, tp = setup
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == len(tpr.leaves(tp))
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
    assert tpr.count(LM(tcfg).param_specs()) \
        == jpr.count(j_build(jcfg).param_specs()) == tcfg.param_count()


def test_loss_and_aux_match_reference(setup):
    jcfg, tcfg, tree, tp = setup
    batch = model_inputs(tcfg, B, S)
    jloss, jm = jax.jit(j_build(jcfg).loss_fn)(tree, batch)
    tloss, tm = build_model(tcfg).loss_fn(tp, to_torch(batch))
    for got, want in ((tloss, jloss), (tm["ce"], jm["ce"]),
                      (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=RTOL * 1e-2)
    if tcfg.moe is not None:
        assert float(tm["aux"]) > 0


@pytest.mark.parametrize("impl", ["flash", "blocked"])
def test_prefill_then_decode_matches_reference(setup, impl):
    jcfg, tcfg, tree, tp = setup
    jm = j_build(jcfg, attn_impl=impl, kv_block=8)
    tm = build_model(tcfg, attn_impl=impl, kv_block=8)
    batch = model_inputs(tcfg, B, S)

    jl, jc = jax.jit(jm.prefill_fn)(tree, batch)
    tl, tc = tm.prefill_fn(tp, to_torch(batch))
    _close(tl, jl)
    want_keys = ["k", "v", "xk", "xv"] if tcfg.family == "audio" else ["k", "v"]
    assert sorted(tc) == sorted(jc) == sorted(want_keys)
    for name in want_keys:
        _close(tc[name], jc[name])

    # three decode steps into caches with room for them, the reference's
    # tokens fed to both; the cross cache stays at n_frames
    pad = ((0, 0), (0, 0), (0, DECODE_STEPS), (0, 0), (0, 0))
    jcache = {n: np.pad(_np(jc[n]), pad) if n in ("k", "v") else _np(jc[n])
              for n in want_keys}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in jcache.items()}
    decode = jax.jit(jm.decode_fn)
    nxt = np.argmax(_np(jl), axis=-1)[:, None]
    for i in range(DECODE_STEPS):
        jl2, jcache = decode(tree, jcache, {"tokens": nxt,
                                            "pos": np.int32(S + i)})
        tl2, tcache = tm.decode_fn(tp, tcache, {
            "tokens": torch.from_numpy(nxt), "pos": S + i})
        _close(tl2, jl2)
        nxt = np.argmax(_np(jl2), axis=-1)[:, None]
    for name in want_keys:
        _close(tcache[name], jcache[name])


def test_image_embeds_replace_the_first_positions():
    """vlm: the first n_img_tokens positions are the image embeddings, the
    tokens there are ignored, and the sequence length is the prompt's."""
    cfg = reduced_config(ARCHS["paligemma-3b"])
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    batch = to_torch(model_inputs(cfg, 1, 9))
    other = dict(batch, tokens=batch["tokens"].clone())
    other["tokens"][:, :cfg.n_img_tokens] = 0
    a, ca = m.prefill_fn(p, batch)
    b, _ = m.prefill_fn(p, other)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ca["k"].shape[2] == 9

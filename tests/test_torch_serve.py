"""Serving: greedy ServeEngine tokens and KV-cache sizes equal the JAX
package's (exact).

Reduced chatglm3-6b with ``attn_impl="flash"`` on both sides (the port's
plain flash on the CPU, the reference's Pallas kernel in interpret mode),
the same perturbed parameters, prompts of several lengths including
len == n_layers (the ``_pad_cache`` case) and two ``max_seq``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as j_reduced
from repro.models.lm import build_model as j_build
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.kvcache import cache_bytes as j_cache_bytes
from repro.serve.kvcache import kv_token_bytes as j_kv_token_bytes
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import cache_bytes, kv_token_bytes

DENSE = sorted(n for n, c in ARCHS.items() if c.family == "dense")


def perturbed_params(cfg, seed):
    """Reference init + seeded noise on every leaf, as a numpy tree."""
    params = j_build(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


@pytest.fixture(scope="module")
def models():
    jcfg = j_reduced(JARCHS["chatglm3-6b"])
    tcfg = reduced_config(ARCHS["chatglm3-6b"])
    tree = perturbed_params(jcfg, seed=2)
    return (j_build(jcfg, attn_impl="flash"), tree,
            build_model(tcfg, attn_impl="flash"),
            params_from_jax(tree, tcfg, device="cpu"))


@pytest.mark.parametrize("max_seq,lengths", [(16, (2, 5, 11)), (24, (2,))])
def test_greedy_tokens_equal_reference(models, max_seq, lengths):
    jm, jp, tm, tp = models
    assert tm.cfg.n_layers in lengths                  # the _pad_cache case
    rng = np.random.default_rng(max_seq)
    prompts = [[int(t) for t in rng.integers(0, tm.cfg.vocab_size, size=n)]
               for n in lengths]
    want = JServeEngine(jm, jp, max_seq=max_seq).generate(prompts,
                                                          max_new_tokens=5)
    eng = ServeEngine(tm, tp, max_seq=max_seq, device="cpu")
    got = eng.generate(prompts, max_new_tokens=5)
    assert got == want
    assert [t.prompt_len for t in eng.timings] == list(lengths)
    assert all(t.decode_steps == 4 for t in eng.timings)


def test_pad_cache_pads_only_kvseq_axis(models):
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, max_seq=24, device="cpu")
    prompt = list(range(1, tm.cfg.n_layers + 1))       # len == n_layers
    _, cache = eng._prefill_one(prompt)
    for leaf in cache.values():
        assert leaf.shape == (tm.cfg.n_layers, 1, 24, tm.cfg.n_kv_heads,
                              tm.cfg.head_dim)
        assert torch.count_nonzero(leaf[:, :, len(prompt):]) == 0


@pytest.mark.parametrize("arch", DENSE)
def test_cache_bytes_equal_reference(arch):
    jm, tm = j_build(JARCHS[arch]), build_model(ARCHS[arch])
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        for batch, seq in ((1, 1), (2, 333), (128, 32_768)):
            assert cache_bytes(tm, batch, seq, tdt) \
                == j_cache_bytes(jm, batch, seq, jdt)
        assert kv_token_bytes(tm, tdt) == j_kv_token_bytes(jm, jdt)


def test_sampling_is_a_function_of_the_seed(models):
    """Temperature sampling draws from the engine's seeded generator: the
    same seed gives the same tokens, another seed other tokens."""
    _, _, tm, tp = models
    prompts = [[3, 1, 4, 1, 5], [2, 7]]

    def run(seed):
        eng = ServeEngine(tm, tp, max_seq=32, temperature=0.8, seed=seed,
                          device="cpu")
        return eng.generate(prompts, max_new_tokens=6)

    assert run(0) == run(0)
    assert run(0) != run(1)


def test_sample_logits_greedy_and_top1():
    from repro_torch.serve.engine import sample_logits
    logits = torch.tensor([[0.1, 2.0, -1.0, 2.0], [5.0, 0.0, 0.0, 1.0]])
    assert sample_logits(logits, None).tolist() == [1, 0]   # first max wins
    gen = torch.Generator().manual_seed(0)
    assert sample_logits(logits[1:], gen, temperature=1.0,
                         top_k=1).tolist() == [0]

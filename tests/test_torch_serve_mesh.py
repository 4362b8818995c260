"""Serving on a gloo mesh: ``ServeEngine(rules=)``'s greedy tokens equal the
reference's unsharded ``ServeEngine`` (exact).

Reduced chatglm3-6b (flash attention: the port's ``flash_attention``
custom op under its DTensor sharding strategy, the reference's Pallas
kernel in interpret mode; and blocked attention, whose prefill splits 4
query heads over 1 KV head on 'model': each rank attends with its own
heads) and mamba2-1.3b (the SSD kernel ops; the
reference's Pallas scan in interpret mode), the same perturbed parameters,
prompts of several lengths.  One spawn of two gloo ranks serves both on a
(1, 2) mesh: the parameters split on 'model' where their dims divide, the
KV cache's sequence on 'kvseq', which decode writes rank by rank.
"""
import jax
import numpy as np
import pytest

from _mesh_workers import serve_cases, spawn
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as j_reduced
from repro.models.lm import build_model as j_build
from repro.serve.engine import ServeEngine as JServeEngine

CASES = {"chatglm3-6b": dict(attn_impl="flash"),
         "mamba2-1.3b": dict(ssd_impl="pallas"),
         # the blocked attention's prefill: 4 query heads over 1 KV head,
         # the heads split on 'model', each rank attending with its own
         "chatglm3-6b-blocked": dict(attn_impl="blocked")}
MAX_SEQ, NEW_TOKENS, LENGTHS = 32, 5, (2, 7, 13)


def _tree(jcfg, seed=2):
    params = j_build(jcfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    rng = np.random.default_rng(3)
    cases, want = [], {}
    for name, kw in CASES.items():
        arch = name.removesuffix("-blocked")
        jcfg = j_reduced(JARCHS[arch])
        tree = _tree(jcfg)
        prompts = [[int(t) for t in rng.integers(0, jcfg.vocab_size, n)]
                   for n in LENGTHS]
        want[name] = JServeEngine(j_build(jcfg, **kw), tree,
                                  max_seq=MAX_SEQ).generate(
            prompts, max_new_tokens=NEW_TOKENS)
        flat = {}

        def walk(t, prefix):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    flat[f"{prefix}{k}"] = v
        walk(tree, "")
        tree_file = tmp / f"{name}.npz"
        np.savez(tree_file, **flat)
        cases.append((name, arch, tree_file, prompts, NEW_TOKENS, MAX_SEQ,
                      kw.get("attn_impl", "flash")))
    got = spawn(serve_cases, 2, tmp, cases)
    return got, want


@pytest.mark.parametrize("arch", sorted(CASES))
def test_mesh_greedy_tokens_equal_reference(served, arch):
    got, want = served
    assert got[0][arch] == want[arch]
    assert got[1][arch] == want[arch]          # both ranks pick alike

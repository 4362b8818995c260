"""The port's train step on gloo meshes against the reference's unsharded
step.

Reduced chatglm3-6b (``blocked`` attention) and mamba2-1.3b (the SSD
kernel ops, K4 and K5 as custom ops with DTensor sharding strategies; on
the CPU their plain versions) train for 3 steps in f32 from the same
numpy parameters (the reference's init, through ``models/convert.py``) on
batches whose rows differ, so that a wrong split of the batch over 'data'
would show in the loss.  One spawn of four gloo ranks runs, for each
model, a (2, 1) mesh on ranks 0-1 beside a (1, 2) mesh on ranks 2-3, then
a (2, 2) mesh on all four.  The ranks force the port's own DTensor
strategies for ``flip``, ``softplus`` and ``softplus_backward`` over this
torch's (the card's older torch has none), so that Mamba2's cumsum
backward and dt meet them at Shard placements.

* Each mesh's losses equal the reference's unsharded ``make_train_step``
  (``rules=None``, what its ``train_loop`` jits) at rtol 1e-4, the
  reference's own mesh-test tolerance.
* Each mesh's gradient norms equal the port's no-mesh step's at rtol
  1e-4, and its final parameters at 1e-4
  (rtol = atol): the mesh changes the order of the sums only (partial sums
  over ranks, all-reduced), and AdamW's three steps move each element by
  at most ~3 lr = 9e-4, so a mismatch in the update would show.
"""
import jax
import numpy as np
import pytest

from _mesh_workers import _params, _run, spawn, train_cases
from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRunConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import reduced_config as j_reduced
from repro.models.lm import build_model as j_build
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config

CASES = [("chatglm3-6b", "chunked", "jnp"), ("mamba2-1.3b", "kernel", "jnp")]
BATCH, SEQ, STEPS = 4, 32, 3
KW = dict(param_dtype="float32", compute_dtype="float32")


def _inputs(arch, tmp_path):
    jcfg = j_reduced(JARCHS[arch])
    tree = jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.PRNGKey(0)))
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v, np.float32)
    walk(tree, "")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (STEPS, BATCH, SEQ))
    tree_file, tok_file = tmp_path / f"{arch}_tree.npz", tmp_path / f"{arch}_tok.npy"
    np.savez(tree_file, **flat)
    np.save(tok_file, toks)
    return jcfg, tree, toks, tree_file, tok_file


def _reference_losses(jcfg, tree, toks):
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("t", SEQ, BATCH, "train"),
                      **KW)
    jmodel = j_build(jcfg)
    jstep, *_, jinit = j_make_train_step(jmodel, jrun, None)
    jstep = jax.jit(jstep)
    params, opt = tree, jinit(tree)
    out = []
    for t in toks:
        params, opt, m = jstep(params, opt, {"tokens": t.astype(np.int32)})
        out.append(float(m["loss"]))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    cases, refs = [], {}
    for arch, impl, _ in CASES:
        jcfg, tree, toks, tree_file, tok_file = _inputs(arch, tmp)
        run = RunConfig(model=reduced_config(ARCHS[arch]),
                        shape=ShapeConfig("t", SEQ, BATCH, "train"), **KW)
        refs[arch] = (_reference_losses(jcfg, tree, toks), run, tree_file,
                      toks, impl)
        cases.append((arch, impl, run, tree_file, tok_file))
    per_rank = spawn(train_cases, 4, tmp, cases)
    got = {}
    for r in per_rank:
        got.update(r)
    for arch, (_, run, tree_file, toks, impl) in refs.items():
        got[(arch, None)] = _run(run.model, run, impl,
                                 _params(tree_file, run.model), list(toks),
                                 None)
    return got, refs


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_mesh_losses_match_the_reference_unsharded(results, arch, mesh):
    got, refs = results
    losses, _, _ = got[(arch, mesh)]
    np.testing.assert_allclose(losses, refs[arch][0], rtol=1e-4)


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_mesh_parameters_match_the_no_mesh_step(results, arch, mesh):
    got, _ = results
    want_losses, want, want_norms = got[(arch, None)]
    losses, params, norms = got[(arch, mesh)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-4)
    assert params.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(params[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)

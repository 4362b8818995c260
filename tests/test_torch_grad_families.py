"""Gradients of ``loss_fn`` for the moe, vlm and audio families against
``jax.grad`` of the reference's, leaf by leaf, at reduced size.

The same kind of perturbed parameters and inputs as
test_torch_lm_families.py (``tests/_families.py``), f32 throughout, ``blocked`` attention in both packages and the
models' own ``remat="full"`` (``torch.utils.checkpoint`` in the port,
``jax.checkpoint`` in the reference).  The MoE backward reaches the router
through the gates and the expert weights through the dispatched rows; the
routing itself (sort, ranks, capacity) carries no gradient in either.

Tolerance.  The reference's init draws every matrix with the fan-in of its
stacked leaf (std 1/sqrt(2) at two layers), so these reduced models amplify
rounding: moving every parameter by 1e-7 of itself (about one f32 ulp)
moves the reference's own gradient by up to 7e-3 of a leaf's largest |g|
(whisper's encoder; 1e-4 to 4e-4 for the others), far past the 1e-4 that
summation order alone would give a well-conditioned step.  So each leaf is
held to 1e-4 of its largest |g| plus 4 times that measured move of the
reference's gradient, measured here on the reference alone, leaf by leaf
(the largest ratio of the port's error to it seen on these inputs: 2.8).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as j_reduced
from repro.models.lm import build_model as j_build
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models import params as tpr
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import build_model
from _families import FAMILY_ARCHS, model_inputs, perturbed_params, to_torch

RTOL = 1e-4
NUDGE = 1e-7          # relative move of every parameter: ~1 f32 ulp
SENSITIVITY_FACTOR = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_gradient_matches_jax_grad(arch):
    jcfg, tcfg = j_reduced(JARCHS[arch]), reduced_config(ARCHS[arch])
    tree = perturbed_params(jcfg, seed=3)
    batch = model_inputs(tcfg, 2, 16, seed=4)
    jm = j_build(jcfg)
    grad_fn = jax.jit(jax.grad(lambda p: jm.loss_fn(p, batch)[0]))
    rng = np.random.default_rng(5)
    nudged = _flat(jax.tree.map(np.asarray, grad_fn(jax.tree.map(
        lambda a: (a * (1 + NUDGE * rng.standard_normal(a.shape)))
        .astype(np.float32), tree))))
    want = grad_fn(tree)

    tp = params_from_jax(tree, tcfg, device="cpu")
    leaves = [t.requires_grad_(True) for t in tpr.leaves(tp)]
    loss, _ = build_model(tcfg).loss_fn(tp, to_torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    got = _flat(tpr.tree_map(lambda _, g=iter(grads): next(g), tp))
    want = _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name]
        assert np.isfinite(w).all(), name
        moved = np.abs(nudged[name] - w).max()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=RTOL * np.abs(w).max() + SENSITIVITY_FACTOR * moved,
            err_msg=name)
    if tcfg.moe is not None:           # the router learns through the gates
        assert np.abs(want["layers/moe/router"]).max() > 0

"""The port's MoE FFN (``models.moe``) against the reference's ``apply_moe``
on the same parameters and inputs, in the cases of the reference's own MoE
tests (tests/test_attention_moe_ssm.py): output and auxiliary loss, a
single expert equal to the dense MLP, capacity drops, the shared expert and
decode's one global group; plus the capacity arithmetic, top-2 with a
gelu MLP (grok-1's kind) and a gradient.

f32; outputs within 1e-5 relative and 1e-5 of the largest |value| (one
layer of f32 matmuls from identical inputs, summation order only); the
aux loss within 1e-6 relative.  Routing is discrete: it agrees because the
router's probabilities from random weights hold no ties.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import params as jpr
from repro.models.moe import apply_moe as j_apply_moe
from repro.models.moe import capacity as j_capacity
from repro.models.moe import moe_params as j_moe_params
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import params as tpr
from repro_torch.models.layers import apply_mlp
from repro_torch.models.moe import apply_moe, capacity, moe_params

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(E=4, top_k=2, cf=2.0, shared=0, kind="swiglu"):
    kw = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab_size=64, mlp_kind=kind)
    return (JModelConfig(**kw, moe=JMoEConfig(
                n_experts=E, top_k=top_k, capacity_factor=cf,
                n_shared_experts=shared)),
            ModelConfig(**kw, moe=MoEConfig(
                n_experts=E, top_k=top_k, capacity_factor=cf,
                n_shared_experts=shared)))


def _params(jcfg, seed=0):
    """The reference's init of the MoE tree as numpy, and the same tensors."""
    tree = jax.tree.map(np.asarray, jpr.init(j_moe_params(jcfg),
                                             jax.random.PRNGKey(seed)))
    return tree, {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(jcfg, tcfg, x, seed=0, train=False):
    jp, tp = _params(jcfg, seed)
    jout, jaux = jax.jit(lambda p, x: j_apply_moe(p, x, jcfg, train))(jp, x)
    dropped = []
    tout, taux = apply_moe(tp, torch.from_numpy(x), tcfg, train,
                           dropped=dropped)
    return (np.asarray(jout), float(jaux)), (tout, float(taux)), tp, dropped


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_specs_and_capacity_match_reference():
    for E, k, cf, shared, kind in ((4, 2, 2.0, 0, "swiglu"),
                                   (16, 1, 1.25, 1, "swiglu"),
                                   (8, 2, 1.25, 0, "geglu"),
                                   (4, 1, 1.0, 0, "gelu")):
        jcfg, tcfg = _cfgs(E, k, cf, shared, kind)
        js, ts = j_moe_params(jcfg), moe_params(tcfg)
        assert sorted(js) == sorted(ts)
        for name in js:
            assert (js[name].shape, js[name].axes, js[name].init) \
                == (ts[name].shape, ts[name].axes, ts[name].init)
        for T in (1, 4, 13, 64, 2048):
            assert capacity(T, tcfg) == j_capacity(T, jcfg)
    # llama4-scout's 2048-token group: 16 experts top-1 at 1.25 -> 160 slots
    assert capacity(2048, _cfgs(16, 1, 1.25, 1)[1]) == 160


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_output_and_aux_match_reference(kind):
    jcfg, tcfg = _cfgs(kind=kind)
    (jout, jaux), (tout, taux), _, _ = _both(jcfg, tcfg, _x((2, 16, 32)),
                                             train=True)
    _close(tout, jout)
    assert taux > 0
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)


def test_single_expert_equals_dense():
    """E=1 top-1 with capacity >= T: the plain MLP of that expert, in both."""
    jcfg, tcfg = _cfgs(E=1, top_k=1, cf=1.0)
    x = _x((2, 16, 32))
    (jout, _), (tout, _), tp, dropped = _both(jcfg, tcfg, x)
    _close(tout, jout)
    dense = {"wi_gate": tp["wi_gate"][0], "wi_up": tp["wi_up"][0],
             "wo": tp["wo"][0]}
    _close(tout, apply_mlp(dense, torch.from_numpy(x), "swiglu").numpy(),
           tol=2e-5)
    assert int(dropped[0]) == 0


def test_capacity_drops_tokens():
    """A capacity far below the load: dropped tokens' rows are zero in both
    packages, the same rows, and the drop count is what the load implies."""
    jcfg, tcfg = _cfgs(E=2, top_k=1, cf=0.1)
    T = 64
    C = capacity(T, tcfg)
    assert C < T // 2
    (jout, _), (tout, _), _, dropped = _both(jcfg, tcfg, _x((1, T, 32)))
    _close(tout, jout)
    zero = np.all(np.abs(tout.numpy()[0]) < 1e-9, axis=-1)
    assert zero.sum() >= T - 2 * C
    np.testing.assert_array_equal(zero, np.all(np.abs(jout[0]) < 1e-9, -1))
    assert int(dropped[0]) == zero.sum()


def test_shared_expert_added():
    jcfg_sh, tcfg_sh = _cfgs(shared=1)
    _, tcfg_ns = _cfgs(shared=0)
    x = _x((1, 8, 32))
    (jout, _), (tout, _), tp, _ = _both(jcfg_sh, tcfg_sh, x)
    _close(tout, jout)
    tp_ns = {k: v for k, v in tp.items() if not k.startswith("shared")}
    out_ns, _ = apply_moe(tp_ns, torch.from_numpy(x), tcfg_ns, False)
    shared = {"wi_gate": tp["shared_wi_gate"], "wi_up": tp["shared_wi_up"],
              "wo": tp["shared_wo"]}
    want = out_ns + apply_mlp(shared, torch.from_numpy(x), "swiglu")
    _close(tout, want.numpy(), tol=2e-5)


def test_decode_is_one_global_group():
    """S == 1: the batch's tokens route as one group of B, in both."""
    jcfg, tcfg = _cfgs()
    x = _x((4, 1, 32))
    (jout, jaux), (tout, taux), tp, _ = _both(jcfg, tcfg, x)
    assert tout.shape == (4, 1, 32)
    _close(tout, jout)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)
    # one group of 4 is not four groups of 1: the same tokens as (1, 4, d)
    one_seq, _ = apply_moe(tp, torch.from_numpy(x.reshape(1, 4, 32)), tcfg,
                           False)
    _close(tout.reshape(1, 4, 32), one_seq.numpy())


def test_gradient_matches_jax_grad():
    jcfg, tcfg = _cfgs(shared=1)
    jp, tp = _params(jcfg)
    x = _x((2, 16, 32))

    def j_loss(p, x):
        out, aux = j_apply_moe(p, x, jcfg, True)
        return (out ** 2).mean() + aux

    jg, jgx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp, x)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = apply_moe(leaves, xt, tcfg, True)
    loss = (out ** 2).mean() + aux
    grads = torch.autograd.grad(loss, [*leaves.values(), xt])
    for (name, g) in zip(leaves, grads):
        _close(g, np.asarray(jg[name]))
    _close(grads[-1], np.asarray(jgx))
    assert tpr.count(moe_params(tcfg)) == jpr.count(j_moe_params(jcfg))

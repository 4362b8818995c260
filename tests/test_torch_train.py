"""The port's train step against the JAX package's, at reduced size.

Both packages get the same parameters (the reference's init plus seeded
numpy noise, f32) and the same synthetic batches, and take one and then a
second step of ``make_train_step`` (the reference's with no mesh): AdamW
with its f32 state, gradient clipping, and with ``microbatch`` 1 of a batch
of 2 also the f32 gradient accumulation over two microbatches.  The loss,
the gradient norm and every parameter after each step must agree at 1e-4
(rtol = atol), in f32 throughout: the paths differ in summation order only.

Each step starts from the same state in both packages: the second from the
reference's state after the first.  AdamW amplifies rounding: its first
update is about ``lr * sign(g)`` wherever |g| is well above eps, so an
element whose gradient is hundreds of times below its leaf's typical one,
where rounding decides the sign and size, can move by up to 2 lr (6e-4)
differently in the two packages.  So the 1e-4 is relaxed for such elements
alone, and only as far as this: an element outside 1e-4 passes only if the
reference's gradient there (``jax.grad`` of the reference's loss, so that
the exemption does not rest on the code under test) is under 1e-2 of its
leaf's median nonzero |g|, the two moves differ by at most 2 lr, and such
elements are at most 1e-3 of the leaf.
``test_first_step_differs_only_where_the_gradient_is_tiny`` shows the
effect on its own.  Chained, the port's own second step then reads a
gradient norm ~1e-3 away (tools/torch_parity.py prints it).
Each port ``ssd_impl`` runs against the reference impl it stands for
(``"chunked"``/``"jnp"``, ``"kernel"``/``"pallas"``, the Pallas kernels in
interpret mode); the dense model trains with ``blocked`` attention in both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRunConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import reduced_config as j_reduced
from repro.data.synthetic import SyntheticLMDataset as JDataset
from repro.models.lm import build_model as j_build
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import params as tpr
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.lm import build_model
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.trainer import make_eval_step, make_train_step

TOL = 1e-4
# (arch, port ssd_impl, reference ssd_impl); the models through the SSD
# kernels are in test_torch_train_kernel.py, so that the two files run on two
# test workers
CASES = [("chatglm3-6b", "chunked", "jnp"), ("mamba2-1.3b", "chunked", "jnp")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster, and the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _perturbed(cfg, seed=0):
    params = j_build(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _runs(arch, microbatch, batch=2, seq=32):
    kw = dict(microbatch=microbatch, param_dtype="float32",
              compute_dtype="float32")
    jcfg, tcfg = j_reduced(JARCHS[arch]), reduced_config(ARCHS[arch])
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("t", seq, batch, "train"),
                      **kw)
    trun = RunConfig(model=tcfg, shape=ShapeConfig("t", seq, batch, "train"),
                     **kw)
    return jcfg, tcfg, jrun, trun


def _assert_params_close(got, want, grads, lr):
    """Every parameter at TOL, but for AdamW's amplified elements (above)."""
    assert got.keys() == want.keys()
    for k in want:
        diff = np.abs(got[k] - want[k])
        out = diff > TOL + TOL * np.abs(want[k])
        g = np.abs(grads[k])
        assert (g[out] < 1e-2 * np.median(g[g > 0])).all(), k
        assert (diff[out] <= 2 * lr * (1 + 1e-3)).all(), k
        assert out.sum() <= max(1, 1e-3 * out.size), k


def _ref_grad_fn(jmodel):
    """The reference's loss gradient, ``(tree, tokens) -> {leaf: grad}``:
    what decides which elements AdamW amplifies."""
    grad = jax.jit(jax.grad(lambda p, t: jmodel.loss_fn(p, {"tokens": t})[0]))
    return lambda tree, toks: _flat(grad(tree, jnp.asarray(toks)))


def _port_state(jo, tcfg):
    """The reference's AdamW state as the port's."""
    conv = lambda t: params_from_jax(jax.tree.map(np.asarray, t), tcfg,  # noqa: E731
                                     device="cpu")
    return AdamWState(step=torch.tensor(int(jo.step), dtype=torch.int32),
                      mu=conv(jo.mu), nu=conv(jo.nu))


@pytest.mark.parametrize("microbatch", [0, 1])
@pytest.mark.parametrize("arch,impl,jimpl", CASES)
def test_two_train_steps_match_reference(arch, impl, jimpl, microbatch):
    _check_two_steps(arch, impl, jimpl, microbatch)


def _check_two_steps(arch, impl, jimpl, microbatch):
    jcfg, tcfg, jrun, trun = _runs(arch, microbatch)
    tree = _perturbed(jcfg)
    ds = JDataset(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=2,
                  seed=3)
    jmodel = j_build(jcfg, ssd_impl=jimpl)
    jstep, *_, jopt_init = j_make_train_step(jmodel, jrun, None)
    jstep = jax.jit(jstep)
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jopt_init(jp)
    ref_grads = _ref_grad_fn(jmodel)
    tmodel = build_model(tcfg, ssd_impl=impl)
    tstep, *_, topt_init = make_train_step(tmodel, trun)
    assert isinstance(topt_init(params_from_jax(tree, tcfg, device="cpu")),
                      AdamWState)

    launches = ssd.ssd_chunk.launches, ssd.ssd_chunk_bwd.launches
    for i in range(2):
        toks = ds.batch(i)["tokens"]
        tree = jax.tree.map(np.asarray, jp)
        tp, to, tm = tstep(params_from_jax(tree, tcfg, device="cpu"),
                           _port_state(jo, tcfg),
                           {"tokens": torch.from_numpy(toks).long()})
        grads = ref_grads(tree, toks)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks)})
        for k in ("loss", "grad_norm", "ce", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=k)
        _assert_params_close(_flat(params_to_numpy(tp)), _flat(jp), grads,
                             jrun.learning_rate)
        assert int(to.step) == int(jo.step) == i + 1
    # the CPU never launches a kernel
    assert (ssd.ssd_chunk.launches, ssd.ssd_chunk_bwd.launches) == launches


@pytest.mark.parametrize("arch,impl,jimpl", CASES[:1])
def test_first_step_differs_only_where_the_gradient_is_tiny(arch, impl,
                                                           jimpl):
    _check_first_step_spread(arch, impl, jimpl)


def _check_first_step_spread(arch, impl, jimpl):
    """After one AdamW step, every parameter that moved more than 1e-5
    differently in the two packages has a reference gradient under 1e-2 of
    its leaf's median nonzero |g|: the amplification described above is there, and
    nothing else moves them apart."""
    jcfg, tcfg, jrun, trun = _runs(arch, 0)
    tree = _perturbed(jcfg)
    toks = JDataset(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=2,
                    seed=3).batch(0)["tokens"]
    jmodel = j_build(jcfg, ssd_impl=jimpl)
    jstep, *_, jopt_init = j_make_train_step(jmodel, jrun, None)
    grads = _ref_grad_fn(jmodel)(tree, toks)
    jp = jax.tree.map(jnp.asarray, tree)
    jp, _, _ = jax.jit(jstep)(jp, jopt_init(jp), {"tokens": jnp.asarray(toks)})
    tmodel = build_model(tcfg, ssd_impl=impl)
    tstep, *_, topt_init = make_train_step(tmodel, trun)
    tp = params_from_jax(tree, tcfg, device="cpu")
    tp, _, _ = tstep(tp, topt_init(tp), {"tokens": torch.from_numpy(toks)
                                         .long()})
    want, got = _flat(jp), _flat(params_to_numpy(tp))
    moved = 0
    for k in want:
        apart = np.abs(got[k] - want[k]) > 1e-5
        g = np.abs(grads[k])
        assert (g[apart] < 1e-2 * np.median(g[g > 0])).all(), k
        moved += int(apart.sum())
    assert moved > 0           # the effect is there to be shown


def test_eval_step_matches_the_train_steps_loss():
    _, tcfg, _, trun = _runs("mamba2-1.3b", 0)
    model = build_model(tcfg, ssd_impl="kernel")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(JDataset(tcfg.vocab_size, 32, 2).batch(0)
                            ["tokens"]).long()
    step, *_, opt_init = make_train_step(model, trun)
    ev = make_eval_step(model, trun)({"p": params}["p"], {"tokens": toks})
    _, _, m = step(params, opt_init(params), {"tokens": toks})
    assert float(ev["loss"]) == pytest.approx(float(m["loss"]), rel=1e-6)
    assert ev["loss"].grad_fn is None


def test_remat_changes_nothing_but_memory():
    """remat "full" (checkpointed layers) and "none" give the same loss and
    gradients."""
    _, tcfg, _, _ = _runs("zamba2-1.2b", 0)
    toks = torch.from_numpy(JDataset(tcfg.vocab_size, 32, 2).batch(1)
                            ["tokens"]).long()
    params = build_model(tcfg).init(torch.Generator().manual_seed(1))
    leaves = [t.requires_grad_(True) for t in tpr.leaves(params)]
    out = []
    for remat in ("full", "none"):
        m = build_model(dataclasses.replace(tcfg, remat=remat),
                        ssd_impl="kernel")
        loss, _ = m.loss_fn(params, {"tokens": toks})
        out.append([loss.detach()] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_step_refuses_a_mesh():
    """A mesh comes as ``MeshRules``; anything else is refused (the mesh
    path itself: tests/test_torch_mesh_train.py)."""
    _, tcfg, _, trun = _runs("chatglm3-6b", 0)
    with pytest.raises(TypeError, match="MeshRules"):
        make_train_step(build_model(tcfg), trun, rules=object())

"""The port's training parts against the JAX package: synthetic batches,
schedules, optimizers, the loss, checkpoints and the fault-tolerant loop.

Synthetic batches must be bit-identical (both are numpy).  Schedules, one
AdamW and one Adafactor update and ``next_token_loss`` are held at 1e-6
(rtol = atol; f32 elementwise math from the same inputs).  Checkpoints
flatten a tree in the reference's leaf order.  ``train_loop`` with a
checkpoint directory and an injected fault resumes to the same losses as a
run without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticLMDataset as JDataset
from repro.models.layers import next_token_loss as j_next_token_loss
from repro.train import optimizer as jopt
from repro.train import schedule as jsched
from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.launch import train as ltrain
from repro_torch.models.layers import next_token_loss
from repro_torch.models.lm import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault
from repro_torch.train import optimizer as topt
from repro_torch.train import schedule as tsched

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster, and the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (0, 512, 64, 4), (3, 50280, 33, 3), (7, 65024, 128, 2)])
def test_synthetic_batches_bit_identical(seed, vocab, seq, batch):
    port = SyntheticLMDataset(vocab, seq, batch, seed=seed)
    ref = JDataset(vocab, seq, batch, seed=seed)
    for step in (0, 1, 17):
        got, want = port.batch(step)["tokens"], ref.batch(step)["tokens"]
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["constant", "linear", "cosine", "rsqrt"])
def test_schedules_match(name):
    kw = dict(name=name, base_lr=3e-4, warmup_steps=10, total_steps=100,
              min_lr_ratio=0.1)
    port = tsched.make_schedule(tsched.ScheduleConfig(**kw))
    ref = jsched.make_schedule(jsched.ScheduleConfig(**kw))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 250):
        got, want = port(step), ref(step)
        assert got.dtype == torch.float32
        _close(got, want)


def _opt_tree(seed):
    """A parameter tree with factored (>= 128 x 128) and unfactored leaves,
    its gradients, and a few tiny gradients."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (2, 128, 160), "b": (160,), "e": {"t": (130, 128)},
              "s": (3,)}

    def draw(shape, scale):
        if isinstance(shape, dict):
            return {k: draw(v, scale) for k, v in shape.items()}
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return draw(shapes, 0.1), draw(shapes, 0.01)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_one_optimizer_update_matches(name):
    params, grads = _opt_tree(0)
    cfg_j = jopt.OptConfig(name=name)
    cfg_t = topt.OptConfig(name=name)
    j_init, j_update, _ = jopt.make_optimizer(name, cfg_j)
    t_init, t_update, _ = topt.make_optimizer(name, cfg_t)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_init(jp)
    tp, ts = _t(params), None
    ts = t_init(tp)
    for _ in range(2):          # two updates: the step counter and the state
        jp, js = j_update(jax.tree.map(jnp.asarray, grads), js, jp, 3e-4)
        tp, ts = t_update(_t(grads), ts, tp, 3e-4)
    for g, w in zip(ckpt.flatten(tp), jax.tree.leaves(jp)):
        _close(g, w)
    for g, w in zip(ckpt.flatten(ts), jax.tree.leaves(js)):
        assert g.dtype == (torch.int32 if g.dim() == 0 else torch.float32)
        _close(g, w)


def test_global_norm_and_clip_match():
    _, grads = _opt_tree(1)
    big = jax.tree.map(lambda a: 50 * a, grads)
    for tree in (grads, big):
        got, gnorm = topt.clip_by_global_norm(_t(tree), 1.0)
        want, jnorm = jopt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), 1.0)
        _close(gnorm, jnorm)
        for g, w in zip(ckpt.flatten(got), jax.tree.leaves(want)):
            _close(g, w)


def test_bf16_params_keep_an_f32_state():
    params, grads = _opt_tree(2)
    p = jax.tree.map(lambda t: t.bfloat16(), _t(params))
    init, update, _ = topt.make_optimizer("adamw")
    new_p, state = update(_t(grads), init(p), p, 3e-4)
    assert all(t.dtype == torch.bfloat16 for t in ckpt.flatten(new_p))
    assert all(t.dtype == torch.float32 for t in ckpt.flatten(state.mu))


def test_next_token_loss_matches_with_padded_vocab():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 17, 96)).astype(np.float32) * 3
    tokens = rng.integers(0, 80, size=(2, 17))     # vocab 80, padded to 96
    got = next_token_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                          80)
    want = j_next_token_loss(jnp.asarray(logits), jnp.asarray(tokens), 80)
    _close(got, want)


def test_checkpoint_leaf_order_is_the_references(tmp_path):
    """flatten() orders leaves as jax.tree.flatten does (sorted dict keys,
    named tuples in order), so a leaf index names the same leaf in both."""
    params, _ = _opt_tree(4)
    state = (params, jopt.adamw_init(jax.tree.map(jnp.asarray, params),
                                     jopt.OptConfig()))
    t_state = (_t(params), topt.adamw_init(_t(params), topt.OptConfig()))
    want = [np.shape(x) for x in jax.tree.leaves(state)]
    assert [tuple(t.shape) for t in ckpt.flatten(t_state)] == want
    path = ckpt.save(tmp_path, 5, t_state, extra={"k": 1}, keep_last=2)
    assert path.name == "step_000000005" and (tmp_path / "LATEST").exists()
    step, back, extra = ckpt.restore(tmp_path, t_state)
    assert step == 5 and extra == {"k": 1}
    assert isinstance(back[1], topt.AdamWState)
    for a, b in zip(ckpt.flatten(back), ckpt.flatten(t_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_keeps_bf16_and_collects_garbage(tmp_path):
    tree = {"a": torch.randn(3, 4).bfloat16(), "n": torch.tensor(7)}
    for step in (1, 2, 3, 4):
        ckpt.save(tmp_path, step, tree, keep_last=2)
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == [
        "step_000000003", "step_000000004"]
    assert ckpt.latest_step(tmp_path) == 4
    _, back, _ = ckpt.restore(tmp_path, tree, step=3)
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"], tree["a"]) and int(back["n"]) == 7


def _run(arch="mamba2-1.3b", batch=2, seq=32):
    cfg = reduced_config(ARCHS[arch])
    run = RunConfig(model=cfg, shape=ShapeConfig("t", seq, batch, "train"),
                    param_dtype="float32", compute_dtype="float32")
    return build_model(cfg, ssd_impl="kernel"), run


def test_train_loop_resumes_after_a_fault_to_the_same_losses(tmp_path):
    model, run = _run()
    clean = ltrain.train_loop(model, run, n_steps=5, device="cpu")
    hit = ltrain.train_loop(
        model, run, n_steps=5, ckpt_dir=str(tmp_path), ckpt_every=2,
        injector=fault.FaultInjector(fail_at_steps=(3,)), device="cpu")
    assert hit.restarts == 1 and hit.steps_done == 5
    # steps 0-2, then the fault at step 3 restores step 2's checkpoint and
    # replays steps 2-4
    assert len(hit.losses) == 6
    np.testing.assert_array_equal(hit.losses[:3], clean.losses[:3])
    np.testing.assert_array_equal(hit.losses[3:], clean.losses[2:])
    assert ckpt.latest_step(tmp_path) == 5
    assert clean.losses[-1] < clean.losses[0]


def test_train_cli_runs_on_the_cpu(capsys):
    assert ltrain.main(["--arch", "zamba2-1.2b", "--reduced", "--device",
                        "cpu", "--steps", "2", "--batch", "2", "--seq",
                        "16"]) == 0
    assert "done: 2 steps" in capsys.readouterr().out


def test_flash_attention_on_the_card_refuses_a_gradient(monkeypatch):
    """On a CUDA tensor the flash kernel (no backward) raises when a
    gradient is wanted instead of returning a result without one.  Checked
    here with the device check patched to say "cuda"; the raise comes
    before anything touches the card (the card test is
    test_flash_kernel_refuses_to_drop_a_gradient)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    monkeypatch.setattr(fa, "_device_type", lambda t: "cuda")
    q = torch.randn((1, 16, 4, 64), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, q, q, causal=True)
    monkeypatch.undo()
    out = ops.flash_attention(q, q, q, causal=True)   # the CPU differentiates
    out.sum().backward()
    assert q.grad is not None

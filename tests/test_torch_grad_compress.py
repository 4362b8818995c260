"""Cross-pod int8 gradient compression against the reference.

* ``_quantize_int8``/``_dequantize_int8`` bit for bit with the reference's
  (its jnp functions run eagerly on the CPU; jitted, XLA turns the
  ``/ 127.0`` into a multiply by the f32 reciprocal and some scales move
  by an ulp, so the oracle is the eager reference).
* ``compressed_pod_sync`` over a 2-rank 'pod' axis of a (2, 1, 1) gloo mesh
  against a numpy oracle built from the reference's functions, applied per
  pod chunk: the per-rank gradients summed in f32, cut into the two pods'
  parts, divided by 2, each part quantized and dequantized with its own
  blocks.  Plain tensors that differ per rank and DTensors replicated over
  'pod' (whose mean is the value itself), leaves whose part is and is not
  a multiple of 128.
* One train step with ``grad_compression="int8_ef"`` on that mesh (the
  batch split over the pods, so the gradients reach the sync as partial
  sums over 'pod'): the loss equals the no-mesh step's, the synced
  gradients' global norm equals the no-mesh step's at rtol 1e-2 (which a
  partial sum divided by the pod count again fails), and the
  parameters move as the no-mesh step's do, up to what the int8 broadcast
  changes in AdamW's first update (at most 2 lr an element).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mesh_workers import _params, _run, pod_sync, spawn
from repro.train.grad_compress import _dequantize_int8 as j_dequantize
from repro.train.grad_compress import _quantize_int8 as j_quantize
from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from repro_torch.models import params as pr
from repro_torch.models.lm import build_model
from repro_torch.train.grad_compress import (_dequantize_int8,
                                             _quantize_int8,
                                             compressed_pod_sync)

SHAPES = {"a": (1000,), "b": (3, 257), "c": (128,), "d": (5, 4, 300),
          "e": (1,), "f": (256, 2)}


def _x(shape, rng):
    x = (rng.standard_normal(shape) * rng.uniform(1e-3, 10)).astype(
        np.float32)
    x.flat[::7] *= 1e-6
    return x


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_quantize_and_dequantize_bit_for_bit(name):
    x = _x(SHAPES[name], np.random.default_rng(len(name) + 7))
    q, s = _quantize_int8(torch.from_numpy(x))
    jq, js = j_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    n = x.shape[-1]
    np.testing.assert_array_equal(_dequantize_int8(q, s, n).numpy(),
                                  np.asarray(j_dequantize(jq, js, n)))


def _oracle(per_rank, g=2):
    """The pod mean of ``per_rank`` (g arrays) as the sync computes it,
    from the reference's functions, one pod part at a time."""
    flat = [a.reshape(-1).astype(np.float32) for a in per_rank]
    n = flat[0].size
    pad = (-n) % g
    total = sum(np.pad(f, (0, pad)) for f in flat)
    m = total.size // g
    parts = []
    for k in range(g):
        part = jnp.asarray(total[k * m:(k + 1) * m] / np.float32(g))
        q, s = j_quantize(part)
        parts.append(np.asarray(j_dequantize(q, s, m)))
    return np.concatenate(parts)[:n].reshape(per_rank[0].shape)


def test_no_pod_axis_is_a_no_op():
    class Duck:
        axis_names = ("data", "model")
        devices = np.zeros((2, 2))
    grads = {"w": torch.ones(3)}
    assert compressed_pod_sync(grads, Duck()) is grads


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod_sync")
    rng = np.random.default_rng(0)
    grads = {k: np.stack([_x(s, rng), _x(s, rng)]) for k, s in SHAPES.items()}
    np.savez(tmp / "grads.npz", **grads)
    cfg = reduced_config(ARCHS["chatglm3-6b"])
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                    param_dtype="float32", compute_dtype="float32",
                    grad_compression="int8_ef")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    np.savez(tmp / "tree.npz", **{
        k: v for k, v in _flat(params).items()})
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 4, 32))
    np.save(tmp / "tok.npy", toks)
    got = spawn(pod_sync, 2, tmp, tmp / "grads.npz",
                (run, tmp / "tree.npz", tmp / "tok.npy"))
    plain_run = RunConfig(model=cfg, shape=run.shape, param_dtype="float32",
                          compute_dtype="float32")
    want_step = _run(cfg, plain_run, "chunked", _params(tmp / "tree.npz", cfg),
                     list(toks), None)
    return grads, got, want_step


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree.numpy()}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_pod_sync_of_per_rank_grads_matches_the_oracle(synced, name):
    grads, got, _ = synced
    want = _oracle(list(grads[name]))
    for rank in (0, 1):
        np.testing.assert_array_equal(got[rank][0][name], want)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_pod_sync_of_a_replicated_dtensor_matches_the_oracle(synced, name):
    grads, got, _ = synced
    want = _oracle([grads[name][0], grads[name][0]])
    for rank in (0, 1):
        np.testing.assert_array_equal(got[rank][1][name], want)
        assert all("Replicate" in p and "Partial" not in p
                   for p in got[rank][2])


def test_int8_ef_train_step_on_a_pod_mesh(synced):
    _, got, (want_losses, want, want_norms) = synced
    losses, params, norms = got[0][3]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    # the synced gradients' norm: int8 blocks move each element by at most
    # half a step of 1/127 of its block's largest (1.4e-4 here); a partial
    # sum divided by the pod count again halves the leaves that reach the
    # sync as partial sums, which moves the norm by 5 % here
    np.testing.assert_allclose(norms, want_norms, rtol=1e-2)
    lr = 3e-4
    moved = 0
    for k in want:
        diff = np.abs(params[k] - want[k])
        assert diff.max() <= 2 * lr * (1 + 1e-3), k
        moved += int((diff > 1e-5).sum())
    total = sum(v.size for v in want.values())
    assert moved <= 0.05 * total
    assert pr.count(build_model(reduced_config(
        ARCHS["chatglm3-6b"])).param_specs()) == total

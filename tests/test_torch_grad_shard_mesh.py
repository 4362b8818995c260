"""The numerics of the gradients and the Adafactor update on gloo meshes,
against the port's no-mesh path (which ``test_torch_train_parts.py`` and
``test_torch_mesh_train.py`` hold against the reference).

One spawn of four gloo ranks runs a (1, 2) mesh on ranks 0-1 beside
another on ranks 2-3, then a (2, 2) mesh on all four:

* ``adafactor_update`` of a factored (2, 128, 256) leaf whose gradient
  and parameter are sharded as FSDP and tensor parallelism shard a
  layer's weight, its row factor on 'data', its column factor arriving
  replicated or on 'model' (the factored second moment's outer product
  runs on each rank's shards, ``optimizer._outer``): the new parameter
  and factors equal the update of the whole tensors.  Only the order of
  the f32 means changes, so the tolerance is rtol 1e-5.
* One train step of reduced nemotron-4-340b (dense) and grok-1-314b
  (MoE) with Adafactor, f32 parameters, bf16 compute and 2 microbatches:
  each gradient is reduced into its parameter's placements in bf16
  before its f32 cast (a stacked leaf's in the layer loop's backward,
  ``core.aten.grad_in_placements``).  Its loss, gradient norm, each
  parameter's move and each Adafactor factor equal the no-mesh step's
  within limits set from this test's readings (``LIMITS``: about
  2x).  The same step in f32 compute agrees to ~1e-5, so what is
  left is bf16's rounding of partial sums.  Adafactor's update does not
  see a gradient's scale, so the gradient norm (within 0.3 %) and the
  factors (g² means, within 3-10 %) carry the check that each reduction
  sums its ranks once: a reduction that drops the other ranks' partial
  sums, or that doubles them, fails every case.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _mesh_workers import (ADAFACTOR_VC, _flat_numpy, _run, grad_shard_cases,
                           spawn)
from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from repro_torch.models.lm import build_model
from repro_torch.train.optimizer import (AdafactorState, OptConfig,
                                         adafactor_update)

ARCHS_BF16 = ["nemotron-4-340b", "grok-1-314b"]
MESHES = ["1x2", "1x2b", "2x2"]
BATCH, SEQ, STEPS, LR = 4, 32, 1, 3e-4


def _run_config(arch):
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]),
                              optimizer="adafactor")
    return RunConfig(model=cfg, shape=ShapeConfig("t", SEQ, BATCH, "train"),
                     param_dtype="float32", compute_dtype="bfloat16",
                     microbatch=BATCH // 2, learning_rate=LR)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grad_shard_mesh")
    rng = np.random.default_rng(0)
    arrays = {"p": rng.standard_normal((2, 128, 256)),
              "g": rng.standard_normal((2, 128, 256)),
              "vr": rng.random((2, 128)) + 0.1,
              "vc": rng.random((2, 256)) + 0.1}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    np.savez(tmp / "adafactor.npz", **arrays)
    cases, want = [], {}
    for arch in ARCHS_BF16:
        run = _run_config(arch)
        toks = rng.integers(0, run.model.vocab_size, (STEPS, BATCH, SEQ))
        np.save(tmp / f"{arch}_tok.npy", toks)
        cases.append((arch, run, tmp / f"{arch}_tok.npy"))
        params = build_model(run.model).init(torch.Generator().manual_seed(0))
        want[arch] = _run(run.model, run, "chunked", params, list(toks), None,
                          state=True)
    ada, steps = {}, {}
    for a, b in spawn(grad_shard_cases, 4, tmp, tmp / "adafactor.npz",
                      cases):
        ada.update(a)
        steps.update(b)
    return arrays, ada, want, steps


def _whole_update(arrays):
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    state = AdafactorState(step=torch.tensor(2, dtype=torch.int32),
                           vr={"w": t["vr"]}, vc={"w": t["vc"]},
                           v={"w": torch.zeros(1)})
    p, st = adafactor_update({"w": t["g"]}, state, {"w": t["p"]}, 1e-2,
                             OptConfig(name="adafactor"))
    return p["w"].numpy(), st.vr["w"].numpy(), st.vc["w"].numpy()


@pytest.mark.parametrize("vc", list(ADAFACTOR_VC))
@pytest.mark.parametrize("mesh", MESHES)
def test_adafactor_on_shards_equals_the_whole_update(results, mesh, vc):
    arrays, ada, _, _ = results
    want = _whole_update(arrays)
    got = ada[(mesh, vc)]
    for name, a, b in zip(("p", "vr", "vc"), got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=name)
    # the update itself, not only the parameter it moves
    np.testing.assert_allclose(arrays["p"] - got[0], arrays["p"] - want[0],
                               rtol=1e-4, atol=5e-7)


def _distances(got, want, p0):
    """How far a step on the mesh lands from the no-mesh step: the loss's
    and the gradient norm's relative difference, and per leaf the largest
    relative (Frobenius) difference of the parameter's move and of each
    Adafactor factor (vr, vc, v) over its size."""
    (loss, params, norms, state), (w_loss, w_params, w_norms, w_state) = \
        got, want
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    return {
        "loss": max(abs(a / b - 1) for a, b in zip(loss, w_loss)),
        "grad_norm": max(abs(a / b - 1) for a, b in zip(norms, w_norms)),
        "move": max(rel(params[k] - p0[k], w_params[k] - p0[k])
                    for k in w_params),
        "factors": max(rel(state[k], w_state[k]) for k in w_state
                       if w_state[k].size > 1),
    }


# about 2x the largest readings over the (1, 2) and (2, 2) meshes (torch
# 2.13 and torch 2.11, on the CPU): nemotron loss 2.8e-4, gradient norm
# 6.6e-4, move 0.037, factors 0.015; grok 2.8e-4, 1.3e-3, 0.124, 0.050.
# A gradient reduced in bf16 on the mesh rounds partial sums the no-mesh
# step rounds once.  grok's are the larger, as its bf16 step lies farther
# from its f32 step without a mesh too (a parameter's move 42 % away,
# nemotron's 3.3 %)
LIMITS = {"nemotron-4-340b": dict(loss=6e-4, grad_norm=1.5e-3, move=0.08,
                                  factors=0.03),
          "grok-1-314b": dict(loss=6e-4, grad_norm=3e-3, move=0.25,
                              factors=0.10)}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS_BF16)
def test_bf16_step_on_a_mesh_equals_the_no_mesh_step(results, arch, mesh):
    _, _, want, steps = results
    got = steps[(arch, mesh)]
    assert got[1].keys() == want[arch][1].keys()
    assert got[3].keys() == want[arch][3].keys()
    p0 = _flat_numpy(build_model(_run_config(arch).model).init(
        torch.Generator().manual_seed(0)))
    d = _distances(got, want[arch], p0)
    assert all(d[k] <= LIMITS[arch][k] for k in d), (d, LIMITS[arch])

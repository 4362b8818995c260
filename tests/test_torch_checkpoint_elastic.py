"""``AsyncCheckpointer`` and the elastic restore onto a mesh.

The reference's ``AsyncCheckpointer`` tests (``tests/test_checkpoint_fault.py``)
on the port: the write overlaps, commits as the synchronous protocol does
and is immune to later changes of the tree; a failed write surfaces at
``wait``.  Then the elastic path: a checkpoint of a no-mesh training state
(reduced chatglm3-6b, f32, after one step) restores through
``restore(shardings=)`` onto a (1, 2) and a (2, 1) gloo mesh, each rank
keeping its shard of every leaf; the next step there gives the loss and
parameters of the same step taken without a mesh (rtol 1e-5 and 1e-4:
the mesh reorders sums only), and the sharded state written back by
``AsyncCheckpointer`` restores without a mesh to the mesh's parameters.
"""
import numpy as np
import pytest
import torch

from _mesh_workers import _flat_numpy, _params, elastic, spawn
from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from repro_torch.models import params as pr
from repro_torch.models.lm import build_model
from repro_torch.train import checkpoint as ck
from repro_torch.train.checkpoint import AsyncCheckpointer
from repro_torch.train.trainer import make_train_step


def test_async_checkpointer_overlaps_and_commits(tmp_path):
    ck_dir = tmp_path / "ck"
    acp = AsyncCheckpointer()
    state = {"w": torch.full((8, 8), 1.0)}
    acp.save(ck_dir, 1, state)
    state["w"].mul_(100.0)            # the live state changes in place
    acp.save(ck_dir, 2, state)        # waits for the first write
    acp.wait()
    assert ck.latest_step(ck_dir) == 2
    _, t1, _ = ck.restore(ck_dir, {"w": torch.zeros(8, 8)}, step=1)
    np.testing.assert_array_equal(t1["w"].numpy(), np.full((8, 8), 1.0))
    _, t2, _ = ck.restore(ck_dir, {"w": torch.zeros(8, 8)}, step=2)
    np.testing.assert_array_equal(t2["w"].numpy(), np.full((8, 8), 100.0))


def test_async_checkpointer_surfaces_errors(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("a file where the directory should go")
    acp = AsyncCheckpointer()
    acp.save(blocker / "ck", 1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        acp.wait()
    acp.wait()                        # the error is raised once


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    cfg = reduced_config(ARCHS["chatglm3-6b"])
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                    param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    np.savez(tmp / "tree.npz", **_flat_numpy(params))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 4, 32))
    np.save(tmp / "tok1.npy", toks[1:])
    step, *_, opt_init = make_train_step(model, run)
    params, opt, _ = step(params, opt_init(params),
                          {"tokens": torch.from_numpy(toks[0]).long()})
    acp = AsyncCheckpointer()
    acp.save(tmp / "ck", 1, (params, opt), extra={"data_step": 1})
    acp.wait()
    got = spawn(elastic, 2, tmp, tmp / "ck", run, tmp / "tree.npz",
                tmp / "tok1.npy")
    # the same next step without a mesh
    like = (_params(tmp / "tree.npz", cfg), opt_init(params))
    _, (p2, o2), _ = ck.restore(tmp / "ck", like)
    p2, _, m = step(p2, o2, {"tokens": torch.from_numpy(toks[1]).long()})
    return tmp, got, float(m["loss"]), _flat_numpy(p2)


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_elastic_restore_onto_a_mesh_continues_the_run(elastic_runs, mesh):
    _, got, want_loss, want = elastic_runs
    for rank in (0, 1):
        at, extra, placements, loss, params = got[rank][mesh]
        assert at == 1 and extra == {"data_step": 1}
        assert any("Shard" in p for p in placements), placements
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for k in want:
            np.testing.assert_allclose(params[k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_sharded_state_written_back_restores_without_a_mesh(elastic_runs,
                                                            mesh):
    tmp, got, _, _ = elastic_runs
    _, _, _, _, params = got[0][mesh]
    cfg = reduced_config(ARCHS["chatglm3-6b"])
    like = build_model(cfg).init(torch.Generator().manual_seed(1))
    at, (restored, _), extra = _restore_params(tmp / f"resaved_{mesh}",
                                               like, cfg)
    assert at == 2 and extra == {"mesh": mesh}
    flat = _flat_numpy(restored)
    for k in params:
        np.testing.assert_array_equal(flat[k], params[k], err_msg=k)
    assert len(pr.leaves(restored)) == len(params)


def _restore_params(ck_dir, like, cfg):
    """Restore (params, AdamW state) and keep the parameters."""
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                    param_dtype="float32", compute_dtype="float32")
    *_, opt_init = make_train_step(build_model(cfg), run)
    at, (params, opt), extra = ck.restore(ck_dir, (like, opt_init(like)))
    return at, (params, opt), extra

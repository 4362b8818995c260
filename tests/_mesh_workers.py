"""Rank programs for the port's gloo mesh tests, and the spawner.

Each test file that needs a process group spawns its ranks once through
``spawn``: ``torch.multiprocessing`` with the ``spawn`` start method, a
``file://`` rendezvous under the test's ``tmp_path`` (no port, safe under
xdist), one torch thread per rank, f32 throughout (gloo reduces in f32).
The rank programs import torch and the port only, never JAX: inputs come
in as numpy files written by the test, and each rank pickles what its
program returns for the test to read.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.parallel.sharding import full_value


def spawn(fn, world: int, tmp_path: Path, *args) -> list:
    """Runs ``fn(rank, world, tmp_path, *args)`` on ``world`` gloo ranks and
    returns each rank's return value (rank order)."""
    mp.spawn(_entry, args=(fn, world, str(tmp_path), args), nprocs=world,
             join=True)
    return [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, Path(tmp), *args)
    finally:
        dist.destroy_process_group()
    (Path(tmp) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def submesh(ranks, names=("data", "model")):
    """A DeviceMesh over ``ranks`` (an array of the mesh's shape); every
    rank of the world must build it."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.as_tensor(np.asarray(ranks)),
                      mesh_dim_names=names)


def _params(tree_file: Path, cfg):
    from repro_torch.models.convert import params_from_jax
    flat = dict(np.load(tree_file))
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)


def _flat_numpy(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_numpy(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: full_value(tree).detach().numpy()}


def _run(cfg, run, impl, params, tokens, mesh, **model_kw):
    """Train steps of the port on ``mesh`` (None: no mesh), one a batch of
    ``tokens``: the losses, the final parameters as numpy and the
    gradients' global norms."""
    from repro_torch.launch.train import host_float, place_batch
    from repro_torch.models import params as pr
    from repro_torch.models.lm import build_model
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.trainer import make_train_step

    model = build_model(cfg, ssd_impl=impl, **model_kw)
    rules = make_rules(mesh) if mesh is not None else None
    step, _, _, p_sh, _, opt_init = make_train_step(model, run, rules)
    if mesh is not None:
        params = pr.distribute(params, p_sh, mesh)
    opt = opt_init(params)
    losses, norms = [], []
    for toks in tokens:
        batch = {"tokens": torch.from_numpy(toks).long()}
        if mesh is not None:
            batch = place_batch(model, run, batch, mesh)
        params, opt, m = step(params, opt, batch)
        losses.append(host_float(m["loss"]))
        norms.append(host_float(m["grad_norm"]))
    return losses, _flat_numpy(params), norms


def train_cases(rank, world, tmp, cases):
    """For each (arch, impl, run, tree file, tokens file): ranks 0-1 train on
    a (2, 1) mesh while ranks 2-3 train on (1, 2), then all four on
    (2, 2).  The port's own strategies for flip, softplus and its backward
    replace this torch's, as on the card's older torch, so that they meet
    Shard placements (the batch over 'data', Mamba2's heads over 'model').
    Returns {(arch, mesh): (losses, params, grad norms)} from the first
    rank of each mesh."""
    from repro_torch.parallel.sharding import register_missing_strategies

    forced = register_missing_strategies(force=True)
    assert forced == ["aten.constant_pad_nd.default", "aten.flip.default",
                      "aten.softplus.default",
                      "aten.softplus_backward.default"], forced
    meshes = {"2x1": submesh([[0], [1]]), "1x2": submesh([[2, 3]]),
              "2x2": submesh([[0, 1], [2, 3]])}
    out = {}
    for arch, impl, run, tree_file, tok_file in cases:
        params = _params(tree_file, run.model)
        tokens = list(np.load(tok_file))
        mine = ["2x1" if rank < 2 else "1x2", "2x2"]
        for name in mine:
            res = _run(run.model, run, impl, params, tokens, meshes[name])
            if rank in (0, 2) and (name != "2x2" or rank == 0):
                out[(arch, name)] = res
    return out


def serve_cases(rank, world, tmp, cases):
    """For each (name, arch, tree file, prompts, new tokens, max_seq,
    attention): greedy tokens of ``ServeEngine(rules=)`` on a (1, world)
    mesh, through the flash op (K3's sharding strategy) or the blocked
    attention, and the SSD kernel ops."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models.lm import build_model
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.serve.engine import ServeEngine

    rules = make_rules(submesh([list(range(world))]))
    out = {}
    for name, arch, tree_file, prompts, new, max_seq, attn in cases:
        cfg = reduced_config(ARCHS[arch])
        model = build_model(cfg, attn_impl=attn, ssd_impl="kernel")
        eng = ServeEngine(model, _params(tree_file, cfg), max_seq=max_seq,
                          device="cpu", rules=rules)
        out[name] = eng.generate(prompts, max_new_tokens=new)
    return out


def pod_sync(rank, world, tmp, grads_file, run_args):
    """``compressed_pod_sync`` over a 2-way 'pod' axis: plain tensors that
    differ per rank, a DTensor replicated over 'pod', and one step of the
    trainer with ``grad_compression="int8_ef"`` on a (2, 1, 1) mesh."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.train.grad_compress import compressed_pod_sync

    mesh = submesh([[[0]], [[1]]], ("pod", "data", "model"))
    data = dict(np.load(grads_file))
    mine = {k: torch.from_numpy(v[rank]) for k, v in data.items()}
    plain = compressed_pod_sync(mine, mesh)
    rep = {k: DTensor.from_local(torch.from_numpy(v[0]), mesh,
                                 [Replicate()] * 3, run_check=False)
           for k, v in data.items()}
    replicated = compressed_pod_sync(rep, mesh)
    cfg_run, tree_file, tok_file = run_args
    step = _run(cfg_run.model, cfg_run, "chunked", _params(tree_file,
                                                          cfg_run.model),
                list(np.load(tok_file))[:1], mesh)
    return ({k: v.numpy() for k, v in plain.items()},
            {k: v.to_local().numpy() for k, v in replicated.items()},
            [str(v.placements) for v in replicated.values()], step)


def elastic(rank, world, tmp, ckpt_dir, run, tree_file, tok_file):
    """Restore a no-mesh checkpoint onto a (1, 2) and a (2, 1) mesh through
    ``restore(shardings=)``, take one step on each, and write an
    ``AsyncCheckpointer`` checkpoint of the sharded state."""
    from repro_torch.launch.train import host_float, place_batch
    from repro_torch.models import params as pr
    from repro_torch.models.lm import build_model
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.trainer import make_train_step

    model = build_model(run.model)
    out = {}
    for name, ranks in (("1x2", [[0, 1]]), ("2x1", [[0], [1]])):
        mesh = submesh(ranks)
        step, _, _, p_sh, o_sh, opt_init = make_train_step(
            model, run, make_rules(mesh))
        like = (_params(tree_file, run.model),
                opt_init(pr.distribute(_params(tree_file, run.model), p_sh,
                                       mesh)))
        at, (params, opt), extra = ck.restore(ckpt_dir, like,
                                              shardings=(p_sh, o_sh),
                                              mesh=mesh)
        placements = sorted({str(t.placements) for t in pr.leaves(params)})
        toks = torch.from_numpy(np.load(tok_file)[0]).long()
        params, opt, m = step(params, opt,
                              place_batch(model, run, {"tokens": toks}, mesh))
        saver = ck.AsyncCheckpointer()
        saver.save(tmp / f"resaved_{name}", at + 1, (params, opt),
                   extra={"mesh": name})
        saver.wait()
        out[name] = (at, extra, placements, host_float(m["loss"]),
                     _flat_numpy(params))
    return out

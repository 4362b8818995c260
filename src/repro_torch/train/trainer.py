"""Train-step builders: gradient accumulation, mixed precision, meshes.

Counterpart of ``repro.train.trainer``.  ``make_train_step`` returns
``(train_step, param_specs, opt_specs, param_placements, opt_placements,
opt_init)``, as the reference's returns its sharding trees; the step is

    (params, opt_state, batch) -> (params, opt_state, metrics)

and, as in the reference: the parameters are cast to ``run.compute_dtype``
for the forward and backward, gradients are taken in f32, microbatches
(``run.microbatch``) accumulate their gradients in f32 and take the mean,
then the gradients are clipped to ``run.grad_clip`` and the optimizer
updates the parameters in their own dtype.  Metrics: ``loss``,
``grad_norm``, ``ce``, ``aux`` (0-d tensors).

With ``rules`` (a ``parallel.sharding.MeshRules`` on a ``DeviceMesh``) the
step takes DTensors: parameters and optimizer state placed by the
placement trees (``models.params.distribute``; ``opt_init`` places the
state it makes), the batch by ``batch_shardings``.  The model's ``lsc``
constraints then redistribute its activations, the gradients are pinned to
the parameters' placements (``constrain_like_params``; the accumulator too,
per microbatch), and with ``run.grad_compression == "int8_ef"`` on a mesh
with a 'pod' axis they are mean-reduced over it by
``grad_compress.compressed_pod_sync`` first.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import RunConfig
from ..models import params as pr
from ..models.lm import LM
from ..parallel.sharding import MeshRules, mesh_axis_names, use_rules
from . import grad_compress
from .optimizer import (
    OptConfig,
    clip_by_global_norm,
    make_optimizer,
    state_spec_tree,
)


def cast_tree(tree, dtype: torch.dtype):
    return pr.tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def _unflatten(like, flat: list):
    it = iter(flat)
    return pr.tree_map(lambda _: next(it), like)


def _redistribute(x, placements, keep: Optional[int] = None):
    """``x`` (a DTensor) redistributed to ``placements``, but for mesh dim
    ``keep``, which stays as it is; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = list(placements)
    if keep is not None:
        placements[keep] = x.placements[keep]
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def batch_shardings(model: LM, shape, rules: MeshRules, specs: dict):
    """Placements of each batch input (``specs``: name -> tensor or meta
    stand-in) from the model's batch logical axes."""
    axes = model.batch_logical_axes(shape)
    return {k: rules.act_placements(axes.get(k, ()), s.shape)
            for k, s in specs.items()}


def distribute_state(state, placements, mesh):
    """An optimizer state (a NamedTuple of trees) onto ``mesh``, field by
    field, with the placements of ``state_spec_tree``'s shardings."""
    return type(state)(*(pr.distribute(f, p, mesh)
                         for f, p in zip(state, placements)))


def make_train_step(model: LM, run: RunConfig,
                    rules: Optional[MeshRules] = None):
    """Builds the train step + placement trees (None without ``rules``)."""
    if rules is not None and not isinstance(rules, MeshRules):
        raise TypeError(f"rules must be a MeshRules, not {type(rules)}")
    cfg = model.cfg
    opt_cfg = OptConfig(name=cfg.optimizer, weight_decay=run.weight_decay,
                        grad_clip=run.grad_clip)
    opt_init, opt_update, _ = make_optimizer(cfg.optimizer, opt_cfg)
    n_micro = run.microbatches()
    compute_dtype = getattr(torch, run.compute_dtype)
    param_specs = model.param_specs()
    opt_specs = state_spec_tree(cfg.optimizer, param_specs, opt_cfg)
    p_sh = o_sh = None
    pod = None
    if rules is not None:
        p_sh = pr.shardings(param_specs, rules)
        o_sh = type(opt_specs)(*(pr.shardings(f, rules) for f in opt_specs))
        names = mesh_axis_names(rules.mesh)
        if run.grad_compression == "int8_ef" and "pod" in names:
            pod = names.index("pod")

    def constrain_like_params(tree, keep: Optional[int] = None):
        """Pin gradients to the parameters' placements (the FSDP layout):
        a partial sum over 'data' is reduce-scattered into the shard."""
        if p_sh is None:
            return tree
        return pr.tree_map(lambda g, pl: _redistribute(g, pl, keep), tree,
                           p_sh)

    def grads_of(leaves, cparams, batch):
        loss, metrics = model.loss_fn(cparams, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(params, opt_state, batch):
        with use_rules(rules):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        cparams = pr.tree_map(
            lambda p: p.detach().to(compute_dtype).requires_grad_(True),
            params)
        leaves = pr.leaves(cparams)
        if n_micro == 1:
            loss, metrics, grads = grads_of(leaves, cparams, batch)
            grads = [g.float() for g in grads]
        else:
            # each accumulator takes its parameter's placements, so each
            # microbatch's gradient is reduced into them as it is added
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            losses, metricses = [], []
            slices = {k: v.chunk(n_micro, dim=0) for k, v in batch.items()}
            for i in range(n_micro):
                loss, metrics, gs = grads_of(
                    leaves, cparams, {k: v[i] for k, v in slices.items()})
                for a, g in zip(grads, gs):
                    a.add_(g.float())
                losses.append(loss)
                metricses.append(metrics)
            grads = [g / n_micro for g in grads]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        del cparams, leaves
        grads = _unflatten(params, grads)
        if pod is not None:
            grads = grad_compress.compressed_pod_sync(
                constrain_like_params(grads, keep=pod), rules.mesh)
        grads = constrain_like_params(grads)
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        new_params, new_opt = opt_update(grads, opt_state, params,
                                         run.learning_rate)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm,
                                     **metrics}

    def init_state(params):
        state = opt_init(params)
        if rules is None:
            return state
        return distribute_state(state, o_sh, rules.mesh)

    return train_step, param_specs, opt_specs, p_sh, o_sh, init_state


def make_eval_step(model: LM, run: RunConfig,
                   rules: Optional[MeshRules] = None):
    """``eval_step(params, batch) -> {"loss", "ce", "aux"}``, no gradients."""
    compute_dtype = getattr(torch, run.compute_dtype)

    @torch.no_grad()
    def eval_step(params, batch):
        with use_rules(rules):
            loss, metrics = model.loss_fn(cast_tree(params, compute_dtype),
                                          batch)
            return {"loss": loss, **metrics}

    return eval_step

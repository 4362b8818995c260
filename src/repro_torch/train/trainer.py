"""Train-step builders: gradient accumulation and mixed precision.

Counterpart of ``repro.train.trainer`` without a mesh.  ``make_train_step``
returns ``(train_step, opt_init)``; the step is

    (params, opt_state, batch) -> (params, opt_state, metrics)

and, as in the reference: the parameters are cast to ``run.compute_dtype``
for the forward and backward, gradients are taken in f32, microbatches
(``run.microbatch``) accumulate their gradients in f32 and take the mean,
then the gradients are clipped to ``run.grad_clip`` and the optimizer
updates the parameters in their own dtype.  Metrics: ``loss``,
``grad_norm``, ``ce``, ``aux`` (0-d tensors).

Meshes (``parallel/``, ROADMAP queue 1 item 8) are not ported, and so
neither is ``grad_compression``, which needs the ``pod`` mesh axis; without
a mesh the reference ignores it too.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import RunConfig
from ..models import params as pr
from ..models.lm import LM
from .optimizer import OptConfig, clip_by_global_norm, make_optimizer


def cast_tree(tree, dtype: torch.dtype):
    return pr.tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def _no_mesh(rules) -> None:
    if rules is not None:
        raise NotImplementedError(
            "the train step takes no mesh yet: parallel/ (and with it "
            "grad_compression over the 'pod' axis) is ROADMAP queue 1 item 8")


def _unflatten(like, flat: list):
    it = iter(flat)
    return pr.tree_map(lambda _: next(it), like)


def make_train_step(model: LM, run: RunConfig, rules: Optional[object] = None):
    """Returns (train_step, opt_init) for ``model`` under ``run``."""
    _no_mesh(rules)
    cfg = model.cfg
    opt_cfg = OptConfig(name=cfg.optimizer, weight_decay=run.weight_decay,
                        grad_clip=run.grad_clip)
    opt_init, opt_update, _ = make_optimizer(cfg.optimizer, opt_cfg)
    n_micro = run.microbatches()
    compute_dtype = getattr(torch, run.compute_dtype)

    def grads_of(leaves, cparams, batch):
        loss, metrics = model.loss_fn(cparams, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(params, opt_state, batch):
        cparams = pr.tree_map(
            lambda p: p.detach().to(compute_dtype).requires_grad_(True),
            params)
        leaves = pr.leaves(cparams)
        if n_micro == 1:
            loss, metrics, grads = grads_of(leaves, cparams, batch)
            grads = [g.float() for g in grads]
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            losses, metricses = [], []
            slices = {k: v.chunk(n_micro, dim=0) for k, v in batch.items()}
            for i in range(n_micro):
                loss, metrics, gs = grads_of(
                    leaves, cparams, {k: v[i] for k, v in slices.items()})
                for acc, g in zip(grads, gs):
                    acc.add_(g.float())
                losses.append(loss)
                metricses.append(metrics)
            grads = [g / n_micro for g in grads]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        del cparams, leaves
        grads, gnorm = clip_by_global_norm(_unflatten(params, grads),
                                           run.grad_clip)
        new_params, new_opt = opt_update(grads, opt_state, params,
                                         run.learning_rate)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm,
                                     **metrics}

    return train_step, opt_init


def make_eval_step(model: LM, run: RunConfig, rules: Optional[object] = None):
    """``eval_step(params, batch) -> {"loss", "ce", "aux"}``, no gradients."""
    _no_mesh(rules)
    compute_dtype = getattr(torch, run.compute_dtype)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss_fn(cast_tree(params, compute_dtype), batch)
        return {"loss": loss, **metrics}

    return eval_step

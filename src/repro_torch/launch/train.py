"""Training entry point: random-weight model, synthetic batches, the train step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --steps 5 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --reduced --device cpu --steps 5 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --mesh 1x1 --steps 3 --batch 4 --seq 2048

Counterpart of ``repro.launch.train``: weights from a seeded
``torch.Generator`` on the device, batches made with numpy
(``data.synthetic``) and moved to the device, the step of
``train.trainer``, and with ``--ckpt-dir`` the fault-tolerant loop of
``train.fault`` over ``train.checkpoint``.  ``--mesh DxM`` trains on a
(data, model) ``DeviceMesh`` (``launch.mesh.make_host_mesh``; one process
makes a one-rank group, so on one card only 1x1): parameters, optimizer
state and batches are DTensors placed by ``parallel.sharding``'s rules.  The CLI trains with
``RunConfig``'s defaults, bf16 parameters and compute with an f32 AdamW
state (the reference's CLI, made for its CPU host, trains in f32).
Attention runs ``blocked`` (the flash kernel K3 has no backward), the
Mamba2 scan through the kernels (K4 forward, K5 backward).  Runs on
``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from ..data.synthetic import SyntheticLMDataset
from ..device import resolve
from ..models import params as pr
from ..models.lm import LM, build_model
from ..parallel.sharding import full_value, make_rules
from ..train import fault
from ..train.trainer import batch_shardings, make_train_step
from .mesh import make_host_mesh


def build_training(model: LM, run: RunConfig,
                   device: str | torch.device = "cuda", mesh=None):
    """Returns (step_fn, init_state, (param placements, optimizer
    placements)): ``step_fn(params, opt_state, batch)`` and
    ``init_state(seed) -> (params, opt_state)`` on ``device``; on ``mesh``
    (a ``DeviceMesh`` of ``device``'s type) the state is DTensors and the
    placements are trees, else None."""
    dev = resolve(device)
    rules = None
    if mesh is not None:
        if mesh.device_type != dev.type:
            raise ValueError(f"a {mesh.device_type} mesh for a {dev.type} "
                             "run")
        rules = make_rules(mesh)
    step_fn, _, _, p_sh, o_sh, opt_init = make_train_step(model, run, rules)

    def init_state(seed: int = 0):
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            dtype=getattr(torch, run.param_dtype))
        if rules is not None:
            params = pr.distribute(params, p_sh, mesh)
        return params, opt_init(params)

    return step_fn, init_state, (p_sh, o_sh)


def place_batch(model: LM, run: RunConfig, batch: dict, mesh) -> dict:
    """The batch's tensors as DTensors on ``mesh``, placed by the model's
    batch logical axes (the batch dim on ('pod', 'data'))."""
    sh = batch_shardings(model, run.shape, make_rules(mesh), batch)
    return pr.distribute(batch, sh, mesh)


def host_float(v) -> float:
    """A 0-d metric as a Python float (a DTensor's full value)."""
    return float(full_value(v))


def train_loop(model: LM, run: RunConfig, *, n_steps: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
               seed: int = 0, log_every: int = 10,
               injector: Optional[fault.FaultInjector] = None,
               device: str | torch.device = "cuda",
               mesh=None) -> fault.LoopReport:
    """``n_steps`` steps on synthetic batches; with ``ckpt_dir``, through
    ``fault.run_with_retries`` (checkpoints every ``ckpt_every`` steps,
    restore and replay on a failure).  The report's ``state`` is the final
    (params, opt_state).  With ``mesh``, on it (``build_training``)."""
    dev = resolve(device)
    shape = run.shape
    train_step, init_state, _ = build_training(model, run, dev, mesh)
    ds = SyntheticLMDataset(vocab_size=model.cfg.vocab_size,
                            seq_len=shape.seq_len,
                            global_batch=shape.global_batch, seed=seed)

    # the vlm and audio inputs: zeros in the compute dtype, as the reference
    # passes them
    specs = model.input_specs(shape, getattr(torch, run.compute_dtype))
    extra = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in specs.items() if k != "tokens"}

    def batch_fn(step: int):
        batch = {"tokens": torch.from_numpy(ds.batch(step)["tokens"]).to(
            dev, torch.long), **extra}
        return batch if mesh is None else place_batch(model, run, batch,
                                                      mesh)

    def step_fn(state, batch):
        params, opt_state = state
        params, opt_state, metrics = train_step(params, opt_state, batch)
        # python floats: reading them waits for the device
        return (params, opt_state), {k: host_float(v)
                                     for k, v in metrics.items()}

    def on_metrics(step: int, metrics: Dict) -> None:
        if step % log_every == 0:
            print(f"  step {step:>5d}  loss {metrics['loss']:8.4f}  "
                  f"grad_norm {metrics['grad_norm']:8.3f}", flush=True)

    if ckpt_dir is None:
        # plain loop, no fault tolerance (quick experiments)
        state = init_state(seed)
        losses, times = [], []
        for step in range(n_steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_fn(step))
            times.append(time.perf_counter() - t0)
            losses.append(metrics["loss"])
            on_metrics(step, metrics)
        return fault.LoopReport(steps_done=n_steps, restarts=0,
                                straggler_events=0, losses=losses,
                                step_times=times, state=state)

    return fault.run_with_retries(
        step_fn=step_fn, init_state=lambda: init_state(seed),
        batch_fn=batch_fn, n_steps=n_steps, ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every, injector=injector, on_metrics=on_metrics)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (smoke) config")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", default="none",
                    help="'none' or 'DxM' (e.g. 1x1): a (data, model) mesh")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = ShapeConfig(name="cli", seq_len=args.seq,
                        global_batch=args.batch, kind="train")
    run = RunConfig(model=cfg, shape=shape, microbatch=args.microbatch,
                    learning_rate=args.lr)
    mesh = None
    if args.mesh != "none":
        d, m = (int(x) for x in args.mesh.split("x"))
        mesh = make_host_mesh(d, m, device_type=device.type)
    model = build_model(cfg, ssd_impl="kernel")
    print(f"training {cfg.name} ({pr.count(model.param_specs()):,} params, "
          f"{run.param_dtype}) for {args.steps} steps, batch {args.batch} x "
          f"seq {args.seq} on {device}"
          + ("" if mesh is None else f", mesh {args.mesh}"))
    rep = train_loop(model, run, n_steps=args.steps, ckpt_dir=args.ckpt_dir,
                     seed=args.seed, device=device, mesh=mesh)
    print(f"done: {rep.steps_done} steps, loss {rep.losses[0]:.4f} -> "
          f"{rep.losses[-1]:.4f}, median step "
          f"{np.median(rep.step_times):.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

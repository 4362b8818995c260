"""Training entry point: random-weight model, synthetic batches, the train step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --steps 5 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --reduced --device cpu --steps 5 --batch 4 --seq 64

Counterpart of ``repro.launch.train`` without a mesh: weights from a seeded
``torch.Generator`` on the device, batches made with numpy
(``data.synthetic``) and moved to the device, the step of
``train.trainer``, and with ``--ckpt-dir`` the fault-tolerant loop of
``train.fault`` over ``train.checkpoint``.  The CLI trains with
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
from ..train import fault
from ..train.trainer import make_train_step


def build_training(model: LM, run: RunConfig,
                   device: str | torch.device = "cuda"):
    """Returns (step_fn, init_state): ``step_fn(params, opt_state, batch)``
    and ``init_state(seed) -> (params, opt_state)`` on ``device``."""
    dev = resolve(device)
    step_fn, opt_init = make_train_step(model, run)

    def init_state(seed: int = 0):
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            dtype=getattr(torch, run.param_dtype))
        return params, opt_init(params)

    return step_fn, init_state


def train_loop(model: LM, run: RunConfig, *, n_steps: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
               seed: int = 0, log_every: int = 10,
               injector: Optional[fault.FaultInjector] = None,
               device: str | torch.device = "cuda") -> fault.LoopReport:
    """``n_steps`` steps on synthetic batches; with ``ckpt_dir``, through
    ``fault.run_with_retries`` (checkpoints every ``ckpt_every`` steps,
    restore and replay on a failure).  The report's ``state`` is the final
    (params, opt_state)."""
    dev = resolve(device)
    shape = run.shape
    train_step, init_state = build_training(model, run, dev)
    ds = SyntheticLMDataset(vocab_size=model.cfg.vocab_size,
                            seq_len=shape.seq_len,
                            global_batch=shape.global_batch, seed=seed)

    # the vlm and audio inputs: zeros in the compute dtype, as the reference
    # passes them
    specs = model.input_specs(shape, getattr(torch, run.compute_dtype))
    extra = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in specs.items() if k != "tokens"}

    def batch_fn(step: int):
        return {"tokens": torch.from_numpy(ds.batch(step)["tokens"]).to(
            dev, torch.long), **extra}

    def step_fn(state, batch):
        params, opt_state = state
        params, opt_state, metrics = train_step(params, opt_state, batch)
        # python floats: reading them waits for the device
        return (params, opt_state), {k: float(v) for k, v in metrics.items()}

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
    model = build_model(cfg, ssd_impl="kernel")
    print(f"training {cfg.name} ({pr.count(model.param_specs()):,} params, "
          f"{run.param_dtype}) for {args.steps} steps, batch {args.batch} x "
          f"seq {args.seq} on {device}")
    rep = train_loop(model, run, n_steps=args.steps, ckpt_dir=args.ckpt_dir,
                     seed=args.seed, device=device)
    print(f"done: {rep.steps_done} steps, loss {rep.losses[0]:.4f} -> "
          f"{rep.losses[-1]:.4f}, median step "
          f"{np.median(rep.step_times):.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end example on the PyTorch port: train a ~100M-parameter LM for
a few hundred steps.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--size 100m]
    PYTHONPATH=src python examples/train_lm_torch.py --size 3m --steps 20 \
        --device cpu

The counterpart of ``examples/train_lm.py``, with its sizes, flags and
defaults: batch 8 x seq 256 in microbatches of 4 (gradient accumulation),
lr 6e-4, f32 parameters and compute, atomic checkpoints every 25 steps and
the fault-tolerant loop (``launch.train.train_loop`` over
``train.fault.run_with_retries``) with a failure injected at step
``steps // 2``, from which the loop restarts at the latest checkpoint and
replays, on the seekable synthetic data pipeline.  The reference's
docstring names a cosine schedule, but its ``train_loop`` never reads the
schedule it builds; the port follows what runs: a constant learning rate.
Attention runs ``blocked`` (the flash kernel has no backward).  The mean
of the last 10 losses must be below that of the first 10 by more than 0.5.
Runs on ``cuda`` unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises.  The checkpoints go to ``--ckpt-dir``
(default: a directory under the system's temporary directory), emptied
first.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.configs import RunConfig, ShapeConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.launch.train import train_loop
from repro_torch.models.lm import build_model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault import FaultInjector

SIZES = {
    # ~100M params: 12L d=768 (GPT-2-small-ish), GQA 12/4, SwiGLU
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=2048, vocab_size=32_000),
    # ~20M for a faster demo run
    "20m": dict(n_layers=8, d_model=384, n_heads=8, n_kv_heads=4,
                d_ff=1024, vocab_size=8_000),
    # ~3M smoke
    "3m": dict(n_layers=4, d_model=192, n_heads=4, n_kv_heads=2,
               d_ff=512, vocab_size=2_000),
}
CKPT_EVERY = 25
LOG_EVERY = 25
LOSS_DROP = 0.5


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", default="20m", choices=sorted(SIZES))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir())
                                / "repro_torch_train_lm"))
    ap.add_argument("--inject-fault", action="store_true", default=True)
    ap.add_argument("--no-inject-fault", dest="inject_fault",
                    action="store_false")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args):
    """(model, run config) of the demo LM that ``args`` describe."""
    cfg = ModelConfig(name=f"demo-{args.size}", family="dense",
                      **SIZES[args.size])
    shape = ShapeConfig(name="demo", seq_len=args.seq,
                        global_batch=args.batch, kind="train")
    run = RunConfig(model=cfg, shape=shape, microbatch=args.microbatch,
                    param_dtype="float32", compute_dtype="float32",
                    learning_rate=args.lr)
    return build_model(cfg), run


def fault_step(args):
    """The step whose execution the injector fails, or None."""
    return args.steps // 2 if args.inject_fault else None


def run(args):
    """Trains as the module docstring says; returns (the loop's report,
    stats: wall seconds, tokens/s, median step ms, one checkpoint's save
    and restore seconds, the first and last 10 losses' means)."""
    device = resolve(args.device)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)   # fresh demo run
    model, run_cfg = build(args)
    print(f"training demo LM: {run_cfg.model.param_count() / 1e6:.1f}M "
          f"params, {args.steps} steps, batch {args.batch} x seq {args.seq} "
          f"on {device}")
    injector = None
    at = fault_step(args)
    if at is not None:
        injector = FaultInjector(fail_at_steps=(at,))
        print(f"(fault injected at step {at}: the loop must restart from "
              f"the latest checkpoint and converge anyway)")
    t0 = time.perf_counter()
    rep = train_loop(model, run_cfg, n_steps=args.steps,
                     ckpt_dir=args.ckpt_dir, ckpt_every=CKPT_EVERY,
                     injector=injector, log_every=LOG_EVERY, device=device)
    wall = time.perf_counter() - t0
    # one checkpoint of the final state, written and read back, timed
    last = ckpt_lib.latest_step(args.ckpt_dir)
    t0 = time.perf_counter()
    ckpt_lib.save(args.ckpt_dir, last + 1, rep.state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt_lib.restore(args.ckpt_dir, rep.state, step=last + 1)
    restore_s = time.perf_counter() - t0
    stats = {"wall_s": wall,
             "tokens_per_s": args.steps * run_cfg.shape.tokens / wall,
             "median_step_ms": float(np.median(rep.step_times)) * 1e3,
             "ckpt_save_s": save_s, "ckpt_restore_s": restore_s,
             "loss_first10": float(np.mean(rep.losses[:10])),
             "loss_last10": float(np.mean(rep.losses[-10:]))}
    print(f"\ndone in {wall:.0f}s ({stats['tokens_per_s']:,.0f} tok/s): "
          f"loss {stats['loss_first10']:.3f} -> {stats['loss_last10']:.3f}, "
          f"restarts={rep.restarts}")
    return rep, stats


def main(argv=None) -> int:
    rep, stats = run(parse_args(argv))
    assert stats["loss_last10"] < stats["loss_first10"] - LOSS_DROP, \
        "loss did not fall"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

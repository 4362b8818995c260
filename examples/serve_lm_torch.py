"""Serve a small model with batched requests (prefill + cached decode) on the
PyTorch port.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu] [--steps N]

The counterpart of ``examples/serve_lm.py``: trains each of the reduced
chatglm3-6b and mamba2-1.3b (vocab 256) on an affine-markov token stream
with a FIXED rule (x[t+1] = (m*x[t] + noise) mod V) for 500 steps of 32 x
64 tokens in f32 (``launch.train.build_training``, lr 3e-3), then serves 4
prompts of 24 tokens for 12 new tokens each through ``ServeEngine``
(``max_seq=48``); the served continuations should follow the learned rule,
which is scored, and more than half must.  On a card the serving path runs
the hand-written kernels: chatglm3-6b serves with ``attn_impl="flash"``
(K3; it trains ``blocked``, as K3 has no backward), and mamba2-1.3b trains
and serves with ``ssd_impl="kernel"`` (K4 forward, K5 backward) — its
"cache" is the SSD state.  Runs on ``cuda`` unless ``--device cpu`` is
given; without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from repro_torch.device import resolve
from repro_torch.launch.train import build_training
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import ServeEngine

MULT = 3
VOCAB = 256
ARCHS_SERVED = ("chatglm3-6b", "mamba2-1.3b")
STEPS = 500


def markov_seq(rng, length):
    x = np.empty(length, np.int64)
    x[0] = rng.integers(0, VOCAB)
    noise = rng.integers(0, 3, size=length)
    for t in range(1, length):
        x[t] = (MULT * x[t - 1] + noise[t]) % VOCAB
    return x


def train_briefly(model, cfg, steps=STEPS, batch=32, seq=64, lr=3e-3,
                  device="cuda"):
    dev = resolve(device)
    shape = ShapeConfig(name="s", seq_len=seq, global_batch=batch,
                        kind="train")
    run = RunConfig(model=cfg, shape=shape, param_dtype="float32",
                    compute_dtype="float32", learning_rate=lr)
    step, init_state, _ = build_training(model, run, dev)
    params, opt = init_state(0)
    rng = np.random.default_rng(0)
    for i in range(steps):
        b = {"tokens": torch.from_numpy(
            np.stack([markov_seq(rng, seq) for _ in range(batch)])).to(dev)}
        params, opt, m = step(params, opt, b)
        if i % 100 == 0 or i == steps - 1:
            print(f"  train step {i}: loss {float(m['loss']):.3f}")
    return params


def rule_accuracy(prompt, out):
    """Fraction of generated transitions consistent with the markov rule."""
    seq = [prompt[-1]] + out
    ok = sum((seq[t + 1] - MULT * seq[t]) % VOCAB in (0, 1, 2)
             for t in range(len(seq) - 1))
    return ok, len(seq) - 1


def serve_arch(arch: str, steps: int = STEPS, device="cuda") -> dict:
    """Train the reduced ``arch`` for ``steps`` steps, serve the 4 prompts
    and score them: ``{"arch", "hits", "total", "accuracy"}``."""
    dev = resolve(device)
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]), vocab_size=VOCAB)
    ssd_impl = "kernel" if cfg.ssm is not None else "chunked"
    print(f"\n=== {arch} (reduced, vocab {VOCAB}) on {dev} ===")
    params = train_briefly(build_model(cfg, ssd_impl=ssd_impl), cfg, steps,
                           device=dev)

    served = build_model(cfg, attn_impl="flash", ssd_impl=ssd_impl)
    engine = ServeEngine(served, params, max_seq=48, device=dev)
    rng = np.random.default_rng(7)
    prompts = [list(markov_seq(rng, 24).astype(int)) for _ in range(4)]
    outs = engine.generate(prompts, max_new_tokens=12)
    hits = total = 0
    for p, o in zip(prompts, outs):
        ok, n = rule_accuracy(p, o)
        hits += ok
        total += n
        print(f"  served {o[:8]}... ({ok}/{n} transitions follow "
              f"the learned rule)")
    print(f"  rule-following accuracy: {hits}/{total} "
          f"({100 * hits / total:.0f}%)")
    return {"arch": arch, "hits": hits, "total": total,
            "accuracy": hits / total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    for arch in ARCHS_SERVED:
        r = serve_arch(arch, args.steps, args.device)
        assert r["accuracy"] > 0.5, "served continuations ignore the rule"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

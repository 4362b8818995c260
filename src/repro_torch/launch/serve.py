"""Serving launcher: random-weight model, random prompts, ServeEngine.generate.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --requests 2 --prompt-len 16 --max-new 8

bf16 parameters; prefill through the kernels: flash attention (K3) and the
SSD intra-chunk kernel (K4).  Every registry architecture serves: the vlm
and audio families get zero ``img_embeds``/``frames`` in the parameters'
dtype, as the reference's launcher passes zeros.  Runs on ``cuda`` unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, ShapeConfig, reduced_config
from ..device import resolve
from ..models.lm import build_model
from ..serve.engine import ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg, attn_impl="flash", ssd_impl="kernel")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, dtype=torch.bfloat16)

    rng = np.random.default_rng(args.seed)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             size=args.prompt_len)]
               for _ in range(args.requests)]

    # the vlm/audio inputs of one request, zeros as in the reference
    specs = model.input_specs(ShapeConfig("serve", args.prompt_len, 1,
                                          "prefill"))
    extra = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in specs.items() if k != "tokens"}

    engine = ServeEngine(model, params,
                         max_seq=args.prompt_len + args.max_new,
                         temperature=args.temperature, seed=args.seed,
                         device=device)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=args.max_new,
                           extra_inputs=extra)
    dt = time.perf_counter() - t0
    total_new = sum(len(o) for o in outs)
    for i, o in enumerate(outs):
        print(f"req {i}: prompt[:8]={prompts[i][:8]} -> {o}")
    print(f"{args.requests} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s) on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

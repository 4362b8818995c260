"""Quickstart on the PyTorch port: build a model, train a few steps, capture
the step and simulate it for the H100.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The counterpart of ``examples/quickstart.py``, walking the paper's flow in
``repro_torch``:
  1. build a registry model (reduced chatglm3-6b, dense GQA) from its config,
  2. run real training steps on the device (B 4, S 64, f32),
  3. capture the step as one ATen graph (``core.aten.capture``, fake
     tensors: nothing runs) and parse it into the ``Program`` IR,
  4.-5. cost it against the ``H100`` spec and its memory hierarchy and
     compose it with the occupancy and O3 schedule engines,
  6. print ``simulate()``'s PA report.
Runs on ``cuda`` unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from repro_torch.core import aten
from repro_torch.core.hwspec import H100
from repro_torch.core.simulate import SimReport, simulate
from repro_torch.device import resolve
from repro_torch.models import params as pr
from repro_torch.models.lm import build_model
from repro_torch.train.trainer import make_train_step

B, S, STEPS = 4, 64, 5


def main(argv=None) -> SimReport:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve(ap.parse_args(argv).device)

    # ------------------------------------------------------------ 1. build
    cfg = reduced_config(ARCHS["chatglm3-6b"])     # tiny same-family config
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        dtype=torch.float32)
    n_params = sum(t.numel() for t in pr.leaves(params))
    print(f"built {cfg.name} (reduced): {n_params:,} params, "
          f"{cfg.n_layers}L d={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads}, on {dev}")

    # ------------------------------------------------------------ 2. train
    run = RunConfig(model=cfg, shape=ShapeConfig("quick", S, B, "train"),
                    param_dtype="float32", compute_dtype="float32",
                    learning_rate=1e-3)
    step, opt_init = make_train_step(model, run)
    opt = opt_init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device=dev)}
    for i in range(STEPS):
        params, opt, metrics = step(params, opt, batch)
        print(f"  step {i}: loss {float(metrics['loss']):.4f}")

    # ---------------------------------------------------- 3. capture, parse
    t0 = time.perf_counter()
    gm = aten.capture(step, params, opt, batch)
    prog = aten.parse_graph(gm)
    print(f"captured the step: {len(gm.graph.nodes)} graph nodes, "
          f"{len(prog.ops)} ops, in {time.perf_counter() - t0:.2f} s")

    # ------------------------------------------------- 4.-6. cost, simulate
    report = simulate(prog, hw=H100, n_chips=1,
                      model_flops_global=6.0 * n_params * B * S,
                      compute_dtype="f32", engine="both",
                      title=f"{cfg.name} quickstart (torch)")
    print()
    print(report.pa)
    print("\nquickstart OK")
    return report


if __name__ == "__main__":
    main()

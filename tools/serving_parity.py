"""The serving simulator's cost cells, the reference's and the port's, side
by side on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/serving_parity.py

For each of the serving sweep's four full models, builds the zoo cost
model (``core.serving.build_zoo_cost_model``: the reduced prefill at batch
1 and the decode grid, each a node-engine estimate on the 48-core A64FX
node, scaled to full depth) in both packages, the reference's from its
XLA HLO under the JAX installed here and the port's from its ATen
capture, and prints a markdown table beside the numbers committed in
``BENCH_serving.json``: prefill us/token, the decode steps' us at each
batch, and the prefill cell's op count.  A second table holds the zoo's
prefill cell (seq 256, batch 2) at 48 cores beside
``BENCH_model_zoo.json``'s, with its op count, and the MB a step that
the largest decode cell moves in each package.  The committed reference
benches were made under an earlier JAX; where their numbers and today's
reference differ, the HLO changed, not the simulator.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

from serving_sweep_torch import FULL_MODELS  # noqa: E402


def main() -> int:
    import dataclasses as dc

    from repro.configs.shapes import ZOO_DECODE, ZOO_PREFILL
    from repro.core import serving as ref_serving
    from repro.core import zoo as ref_zoo
    from repro_torch.core import serving as port_serving
    from repro_torch.core import zoo as port_zoo

    committed = json.loads((ROOT / "BENCH_serving.json").read_text())["models"]
    zoo_bench = json.loads((ROOT / "BENCH_model_zoo.json").read_text())
    pre_shape = dc.replace(ZOO_PREFILL, name="serve_prefill", global_batch=1)
    print("| model | prefill us/token: committed / reference / port | "
          "decode us at b (committed / reference / port) | prefill ops "
          "reference / port |")
    print("| --- | --- | --- | --- |")
    for arch in FULL_MODELS:
        ref = ref_serving.build_zoo_cost_model(arch)
        port = port_serving.build_zoo_cost_model(arch)
        old = committed[arch]
        n_ref = len(ref_zoo.trace_phase(arch, "prefill", pre_shape).ops)
        n_port = len(port_zoo.trace_phase(arch, "prefill", pre_shape).ops)
        decode = "; ".join(
            f"b{b} {c:.1f} / {r * 1e6:.1f} / {p * 1e6:.1f}"
            for (b, c), (_, r), (_, p) in zip(
                old["decode_grid_us"], ref.decode_grid, port.decode_grid))
        print(f"| {arch} | {old['prefill_us_per_token']:.3f} / "
              f"{ref.prefill_per_token * 1e6:.3f} / "
              f"{port.prefill_per_token * 1e6:.3f} | {decode} | "
              f"{n_ref} / {n_port} |")

    b = ref_serving.DECODE_BATCH_GRID[-1]
    dec_shape = dc.replace(ZOO_DECODE, name=f"serve_decode_b{b}",
                           global_batch=b)
    print(f"\n| model | zoo prefill at 48 cores, us: committed / reference / "
          f"port | its ops: committed / reference / port | decode b{b} MB "
          f"a step: reference / port |")
    print("| --- | --- | --- | --- |")
    for arch in FULL_MODELS:
        old = zoo_bench["models"][arch]["phases"]["prefill"]
        progs = [z.trace_phase(arch, "prefill") for z in (ref_zoo, port_zoo)]
        cells = [z.serving_cell_cost(arch, "prefill")
                 for z in (ref_zoo, port_zoo)]
        mb = [z.trace_phase(arch, "decode", dec_shape).bytes_accessed / 1e6
              for z in (ref_zoo, port_zoo)]
        print(f"| {arch} | {old['per_core']['48']['t_est_us']:.1f} / "
              f"{cells[0] * 1e6:.1f} / {cells[1] * 1e6:.1f} | "
              f"{old['n_ops']} / {len(progs[0].ops)} / {len(progs[1].ops)} | "
              f"{mb[0]:.1f} / {mb[1]:.1f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

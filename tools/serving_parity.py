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

A third table splits each decode cell of ``DECODE_BATCH_GRID`` into op
groups (``decode_op_table``): the matmuls, the cache-slab ops (every op
named for a ``dynamic-slice``, ``dynamic-update-slice`` or ``copy``: the
reference's ``lax.scan`` cuts each layer's slab out of the stacked cache
and writes it back, where the port's eager step loops over layer views and
writes its cache in place) and the rest, each with its MB a step, MFLOPs
and op count in both packages, and the remainder of the byte gap that the
matmul and cache groups leave, as a share of the reference's bytes.  A
fourth gives each of those cells' 48-core node-engine estimate (the
reduced trace, A64FX-node µs, not card times) in both packages, with and
without its cache-slab ops, and the op counts: what is left of the gap
without them is the port's eager, unfused ops.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

from serving_sweep_torch import FULL_MODELS  # noqa: E402


CACHE_OPS = ("dynamic-update-slice", "dynamic-slice", "copy")
GROUPS = ("matmul", "cache", "other")


def op_group(op) -> str:
    """``matmul`` for the matmul class (dots and the fusions around them),
    ``cache`` for an op named for a slab slice, update or copy, else
    ``other``."""
    if op.opclass == "matmul":
        return "matmul"
    if any(k in op.name or k == op.opcode for k in CACHE_OPS):
        return "cache"
    return "other"


def decode_op_table(arch: str, batch: int) -> dict:
    """Both packages' decode cell at ``batch`` by op group:
    ``{"reference"|"port": {group: {"n", "mb", "mflops"}}}``, plus
    ``"remainder"``, the byte gap (reference less port) that the matmul
    and cache groups do not explain, over the reference's bytes."""
    import dataclasses as dc

    from repro.configs.shapes import ZOO_DECODE
    from repro.core import zoo as ref_zoo
    from repro_torch.core import zoo as port_zoo

    shape = dc.replace(ZOO_DECODE, name=f"serve_decode_b{batch}",
                       global_batch=batch)
    out = {}
    for side, z in (("reference", ref_zoo), ("port", port_zoo)):
        t = {g: {"n": 0, "mb": 0.0, "mflops": 0.0} for g in GROUPS}
        for o in z.trace_phase(arch, "decode", shape).ops:
            row = t[op_group(o)]
            row["n"] += 1
            row["mb"] += o.bytes_accessed * o.count / 1e6
            row["mflops"] += o.flops * o.count / 1e6
        out[side] = t
    r, p = out["reference"], out["port"]
    total = sum(r[g]["mb"] for g in GROUPS)
    out["remainder"] = (r["other"]["mb"] - p["other"]["mb"]) / total
    return out


def decode_cell_times(arch: str, batch: int) -> dict:
    """Both packages' decode cell at ``batch`` on 48 cores of the A64FX
    node (µs of the reduced trace), in full and without the cache-slab
    ops: ``{"reference"|"port": {"us", "us_no_slab", "ops"}}``."""
    import dataclasses as dc

    from repro.configs.shapes import ZOO_DECODE
    from repro.core import hwspec as ref_hw
    from repro.core import zoo as ref_zoo
    from repro_torch.core import hwspec as port_hw
    from repro_torch.core import zoo as port_zoo

    shape = dc.replace(ZOO_DECODE, name=f"serve_decode_b{batch}",
                       global_batch=batch)
    out = {}
    for side, z, hw in (("reference", ref_zoo, ref_hw.A64FX_CORE),
                        ("port", port_zoo, port_hw.A64FX_CORE)):
        prog = z.trace_phase(arch, "decode", shape)
        bare = dc.replace(prog, ops=[o for o in prog.ops
                                     if op_group(o) != "cache"])

        def us(p):
            return z.estimate_program(p, hw, (48,), hw.topology, "shard",
                                      "f32").at(48).t_est_s * 1e6
        out[side] = {"us": us(prog), "us_no_slab": us(bare),
                     "ops": len(prog.ops)}
    return out


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

    print("\n| model | b | matmul MB, MFLOPs: reference / port | cache-slab "
          "MB (ops): reference / port | other MB (ops): reference / port "
          "| remainder of the gap |")
    print("| --- | --- | --- | --- | --- | --- |")
    for arch in FULL_MODELS:
        for b in ref_serving.DECODE_BATCH_GRID:
            t = decode_op_table(arch, b)
            r, p = t["reference"], t["port"]
            print(f"| {arch} | {b} | {r['matmul']['mb']:.3f}, "
                  f"{r['matmul']['mflops']:.3f} / {p['matmul']['mb']:.3f}, "
                  f"{p['matmul']['mflops']:.3f} | {r['cache']['mb']:.3f} "
                  f"({r['cache']['n']}) / {p['cache']['mb']:.3f} "
                  f"({p['cache']['n']}) | {r['other']['mb']:.3f} "
                  f"({r['other']['n']}) / {p['other']['mb']:.3f} "
                  f"({p['other']['n']}) | {t['remainder']:+.4f} |")

    print("\n| model | b | 48-core µs, reference: in full / without the "
          "slab ops (ops) | port: in full / without them (ops) |")
    print("| --- | --- | --- | --- |")
    for arch in FULL_MODELS:
        for b in ref_serving.DECODE_BATCH_GRID:
            t = decode_cell_times(arch, b)
            r, p = t["reference"], t["port"]
            print(f"| {arch} | {b} | {r['us']:.1f} / {r['us_no_slab']:.1f} "
                  f"({r['ops']}) | {p['us']:.1f} / {p['us_no_slab']:.1f} "
                  f"({p['ops']}) |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

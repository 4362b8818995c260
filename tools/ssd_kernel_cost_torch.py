"""SSD hot-loop cost on the port: the plain chunked path against the Hopper
kernels K4 and K5.  Host code: it needs no card.

    PYTHONPATH=src python3 tools/ssd_kernel_cost_torch.py [--out PATH]

The port's counterpart of ``benchmarks/ssd_kernel_cost.py``, at its
per-device shapes (mamba2-1.3b train_4k on the single-pod mesh,
microbatch 32: B 2, S 4096, H 4, P 64, N 128, chunk 256; 48 layers x 8
microbatches a step).

* **Plain side.**  ``models.ssm.ssd_chunked`` forward and its
  ``torch.autograd.grad`` (x, B, C in bf16; dt, A in f32, as the
  reference's bench), captured by ``core.aten.capture`` over fake tensors
  and parsed: bytes and FLOPs, the dots' FLOPs apart.
* **Kernel side.**  K4's and K5's bounds at the same shape
  (``kernels.bounds``, the function ``chip_smoke.py`` holds the kernels
  against: bytes each input read once and each output written once, and
  the products on the tensor cores), plus what the kernel path runs
  outside them: ``kernels.ops.ssd_scan``'s inter-chunk recurrence and
  ``y_off`` and their backward, captured the same way (the kernels' custom
  calls taken out).  The kernels take dt in x's dtype (bf16).

Each side's memory term is its bytes over the fitted ``H100`` spec's HBM
read rate and its compute term its FLOPs over the spec's bf16 peak, for a
whole step (x 48 x 8); the cut in HBM traffic is one minus the kernel
side's bytes over the plain side's.  These are modelled terms, not times
on a card: ``chip_smoke.py`` phase 32 times K4 + K5 and the plain path at
this shape on the card.  Writes ``--out`` (default
``experiments/ssd_kernel_cost_torch/ssd_kernel_cost.json``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.hwspec import H100  # noqa: E402
from repro_torch.kernels.bounds import (ssd_chunk_bwd_bound,  # noqa: E402
                                        ssd_chunk_fwd_bound)

OUT = Path("experiments/ssd_kernel_cost_torch/ssd_kernel_cost.json")

# mamba2-1.3b train_4k per-device-local SSD shapes (single-pod mesh,
# microbatch 32): B = 32/16 data shards = 2, H = 64/16 model shards = 4
SHAPE = {"B": 2, "S": 4096, "H": 4, "P": 64, "N": 128, "chunk": 256}
L_LAYERS, N_MICRO = 48, 8


def _program(fn, *shapes_dtypes):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.aten import capture, parse_graph
    with FakeTensorMode():
        args = [torch.empty(s, dtype=d) for s, d in shapes_dtypes]
    return parse_graph(capture(fn, *args))


def _grad_of(forward):
    """(x, dt, A, Bm, Cm) -> their gradients of sum(y) + sum(state)."""
    def step(*inputs):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        y, st = forward(*leaves)
        loss = y.float().sum() + st.float().sum()
        return torch.autograd.grad(loss, leaves)
    return step


def _inputs(B, S, H, P, N, dt_dtype):
    bf, f = torch.bfloat16, torch.float32
    return [((B, S, H, P), bf), ((B, S, H), dt_dtype), ((H,), f),
            ((B, S, 1, N), bf), ((B, S, 1, N), bf)]


def _totals(prog) -> dict:
    dots = [o for o in prog.ops if o.opcode == "dot"]
    return {"bytes": prog.bytes_normalized("bf16"), "flops": prog.flops,
            "dot_flops": sum(o.flops * o.count for o in dots),
            "n_ops": len(prog.ops)}


def plain_cost(B, S, H, P, N, chunk) -> dict:
    """The plain chunked path, forward and backward, captured and parsed."""
    from repro_torch.models.ssm import ssd_chunked

    prog = _program(_grad_of(lambda x, dt, A, Bm, Cm: ssd_chunked(
        x, dt, A, Bm, Cm, chunk)), *_inputs(B, S, H, P, N, torch.float32))
    return _totals(prog)


def kernel_cost(B, S, H, P, N, chunk) -> dict:
    """K4's and K5's bounds, and the kernel path's ops outside them."""
    from repro_torch.kernels import ops

    def forward(x, dt, A, Bm, Cm):
        return ops.ssd_scan(x, dt, A, Bm.expand(-1, -1, H, -1),
                            Cm.expand(-1, -1, H, -1), chunk)

    prog = _program(_grad_of(forward),
                    *_inputs(B, S, H, P, N, torch.bfloat16))
    calls = [o for o in prog.ops if o.opcode == "custom-call"]
    if len(calls) != 2:
        raise RuntimeError(f"the kernel path holds {len(calls)} custom "
                           "calls, not K4 and K5")
    prog.ops = [o for o in prog.ops if o.opcode != "custom-call"]
    residue = _totals(prog)
    Q = min(chunk, S)
    k4 = ssd_chunk_fwd_bound(B, S, H, P, N, Q)
    k5 = ssd_chunk_bwd_bound(B, S, H, P, N, Q)
    return {
        "bytes": k4.bytes + k5.bytes + residue["bytes"],
        "flops": k4.flops + k5.flops + residue["flops"],
        "k4": {"bytes": k4.bytes, "flops": k4.flops,
               "bound_ms": k4.bound_ms, "bound_by": k4.bound_by},
        "k5": {"bytes": k5.bytes, "flops": k5.flops,
               "bound_ms": k5.bound_ms, "bound_by": k5.bound_by},
        "outside_kernels": residue,
    }


def rows(B, S, H, P, N, chunk, layers=L_LAYERS, micro=N_MICRO) -> dict:
    """Both sides per layer and microbatch, with the step's modelled memory
    and compute terms on ``H100`` and the cut in HBM traffic."""
    scale = layers * micro
    out = {}
    for name, t in (("plain_chunked", plain_cost(B, S, H, P, N, chunk)),
                    ("kernels", kernel_cost(B, S, H, P, N, chunk))):
        out[name] = {**t,
                     "bytes_per_layer_mb": t["bytes"] / 2**20,
                     "flops_per_layer_gf": t["flops"] / 1e9,
                     "memory_term_s": t["bytes"] * scale / H100.hbm_read_bw,
                     "compute_term_s": t["flops"] * scale
                     / H100.peak_flops["bf16"]}
    out["hbm_traffic_cut"] = 1 - out["kernels"]["bytes"] / \
        out["plain_chunked"]["bytes"]
    out["shape"] = {"B": B, "S": S, "H": H, "P": P, "N": N, "chunk": chunk,
                    "layers": layers, "microbatches": micro}
    out["spec"] = {"name": H100.name, "hbm_read_bw": H100.hbm_read_bw,
                   "peak_bf16": H100.peak_flops["bf16"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    for flag, key in (("--batch", "B"), ("--seq", "S"), ("--heads", "H"),
                      ("--head-dim", "P"), ("--state", "N"),
                      ("--chunk", "chunk")):
        ap.add_argument(flag, type=int, default=SHAPE[key])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    res = rows(args.batch, args.seq, args.heads, args.head_dim, args.state,
               args.chunk)
    for name in ("plain_chunked", "kernels"):
        r = res[name]
        print(f"{name:<14s} {r['bytes_per_layer_mb']:9.2f} MiB "
              f"{r['flops_per_layer_gf']:8.3f} GF a layer and microbatch "
              f"-> step memory term {r['memory_term_s']:.4f} s, compute "
              f"{r['compute_term_s']:.4f} s on {H100.name}")
    print(f"SSD hot-loop HBM traffic cut by the kernels: "
          f"{100 * res['hbm_traffic_cut']:.1f}%")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps({"ssd_kernel_cost": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The reduced models' steps as the reference's HLO and as the port's ATen
capture, side by side, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/aten_parity.py

For reduced chatglm3-6b, mamba2-1.3b and zamba2-1.2b (batch 4, 64 tokens,
f32; the train step and the prefill), builds both programs as
``tests/_aten_ref.py`` does (the reference's XLA:CPU HLO through
``repro.core.hlo.parse_program``, the port's capture through
``repro_torch.core.aten.parse_graph``) and prints a markdown table: ops,
matmul FLOPs and their reckoned gap, and MB by class in each.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

from _aten_ref import programs, reckoned_matmul_gap  # noqa: E402

CASES = [(arch, what) for arch in ("chatglm3-6b", "mamba2-1.3b",
                                   "zamba2-1.2b")
         for what in ("train", "prefill")]
CLASSES = ("matmul", "elementwise", "transcendental", "reduce", "data")


def main() -> int:
    print("| step | ops ref / port | matmul MFLOP ref / port (reckoned gap) | "
          + " | ".join(f"{c} MB ref / port" for c in CLASSES)
          + " | all MB ref / port |")
    print("| --- " * (4 + len(CLASSES)) + "|")
    for arch, what in CASES:
        ref, port, _ = programs(arch, what)
        r, p = ref.by_class(), port.by_class()

        def get(agg, cls, key):
            return agg.get(cls, {}).get(key, 0.0)

        mb = [f"{get(r, c, 'bytes') / 1e6:.2f} / {get(p, c, 'bytes') / 1e6:.2f}"
              for c in CLASSES]
        print(f"| {arch} {what} | {len(ref.ops)} / {len(port.ops)} | "
              f"{get(r, 'matmul', 'flops') / 1e6:.3f} / "
              f"{get(p, 'matmul', 'flops') / 1e6:.3f} "
              f"({reckoned_matmul_gap(arch, what) / 1e6:+.3f}) | "
              + " | ".join(mb)
              + f" | {ref.bytes_accessed / 1e6:.2f} / "
              f"{port.bytes_accessed / 1e6:.2f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())

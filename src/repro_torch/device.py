"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  With no
card and no explicit CPU request they raise: they never carry on silently on
the CPU.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

"""Parameters between the JAX reference (as numpy) and the port.

    params = params_from_jax(jax.tree.map(np.asarray, jax_params), cfg,
                             device="cpu", dtype=torch.float32)
    tree = params_to_numpy(params)     # the reverse, f32 numpy leaves

The trees have the same structure for every family (the MoE router, stacked
experts and shared expert, whisper's encoder and cross-attention included),
so both packages then compute the same function, and updated
parameters compare leaf by leaf.  Takes and gives numpy (never JAX arrays),
so this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve
from . import params as pr
from .lm import LM


def params_from_jax(tree, cfg: ModelConfig, device: str | torch.device = "cuda",
                    dtype: torch.dtype = torch.float32):
    dev = resolve(device)

    def convert(a, p: pr.P):
        a = np.asarray(a, dtype=np.float32)
        if a.shape != p.shape:
            raise ValueError(f"parameter shape {a.shape} != spec {p.shape}")
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev,
                                                            dtype=dtype)

    return pr.tree_map(convert, tree, LM(cfg).param_specs())


def params_to_numpy(tree):
    """The port's parameter tree as f32 numpy arrays, the same structure."""
    return pr.tree_map(lambda t: t.detach().float().cpu().numpy(), tree)

"""Cross-pod gradient compression: a collective-bytes lever.

Counterpart of ``repro.train.grad_compress``.  Within a pod, parameters are
FSDP-sharded and their gradients reduced over 'data'.  Across pods they are
replicated, and gradients are mean-reduced over the 'pod' mesh axis, the
collective this module compresses:

    all-reduce(f32)  ->  reduce-scatter(f32) + all-gather(int8 + f32 scales)

Per-block (128-element) scales keep the quantization error ~0.4 % RMS.  The
reduce-scatter half stays f32 so the *sum* is exact; only the broadcast of
the already-reduced result is quantized.

On torch the sync runs on each rank's local tensor over the mesh's 'pod'
process group (``reduce_scatter_tensor``, ``all_gather_into_tensor``).  A
rank's local tensor is its pod's contribution: a plain tensor or a DTensor
replicated over 'pod' is divided by the pod count after the sum, as in the
reference, and a DTensor whose 'pod' placement is a partial sum is not.
Each pod's part is dequantized with its own blocks, so a part whose length
is not a multiple of 128 keeps its elements in place (the reference
dequantizes the gathered blocks as one vector, which shifts every part
after the first by its padding).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models import params as pr
from ..parallel.sharding import mesh_axis_names, mesh_axis_sizes

BLOCK = 128


def _quantize_int8(x: torch.Tensor):
    """Per-128-block symmetric int8 quantization along the last axis:
    (q (..., nb, 128) int8, scale (..., nb, 1) f32)."""
    n = x.shape[-1]
    xp = F.pad(x, (0, (-n) % BLOCK))
    xb = xp.reshape(xp.shape[:-1] + (-1, BLOCK))
    scale = xb.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.maximum(scale, torch.tensor(1e-12, dtype=scale.dtype))
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int):
    x = q.float() * scale
    return x.reshape(x.shape[:-2] + (-1,))[..., :n]


def compressed_pod_sync(grads, mesh):
    """Mean-reduce a gradient tree across the 'pod' mesh axis with int8
    compression of the broadcast half.  No-op when the mesh has no 'pod'
    axis or it has size 1."""
    from torch.distributed.tensor import DTensor, Replicate

    g = mesh_axis_sizes(mesh).get("pod", 1)
    if g <= 1:
        return grads
    pod = mesh_axis_names(mesh).index("pod")
    group = mesh.get_group("pod")

    def sync_leaf(x):
        local = x.to_local() if isinstance(x, DTensor) else x
        partial = isinstance(x, DTensor) and x.placements[pod].is_partial() \
            and x.placements[pod].reduce_op == "sum"
        flat = local.reshape(-1).float()
        n = flat.numel()
        flat = F.pad(flat, (0, (-n) % g))
        part = flat.new_empty(flat.numel() // g)
        dist.reduce_scatter_tensor(part, flat, group=group)
        if not partial:
            part = part / g
        q, s = _quantize_int8(part)
        q_all = q.new_empty((g * q.shape[0], BLOCK))
        s_all = s.new_empty((g * s.shape[0], 1))
        dist.all_gather_into_tensor(q_all, q, group=group)
        dist.all_gather_into_tensor(s_all, s, group=group)
        # each pod's part dequantized with its own blocks
        out = _dequantize_int8(q_all.view(g, -1, BLOCK), s_all.view(g, -1, 1),
                               part.numel()).reshape(-1)[:n]
        out = out.reshape(local.shape).to(x.dtype)
        if not isinstance(x, DTensor):
            return out
        placements = list(x.placements)
        placements[pod] = Replicate()
        return DTensor.from_local(out, x.device_mesh, placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    return pr.tree_map(sync_leaf, grads)

"""Production meshes on torch.

Counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the reference's axes:

  single-pod:  (16, 16)      -> ("data", "model")          256 ranks
  multi-pod:   (2, 16, 16)   -> ("pod", "data", "model")   512 ranks

'model' is the innermost (fastest-varying) axis, 'pod' the outermost.
Building a mesh never starts more than one process: where no process group
exists, ``make_host_mesh`` and ``make_production_mesh`` start a one-rank
group (NCCL for ``"cuda"``, gloo for ``"cpu"``).  Larger worlds come from
the caller's ``torch.distributed.init_process_group`` (a gloo group of
``mp.spawn``-ed ranks in the tests, torch's fake process group for the
production shapes).  ``"cuda"`` without a card raises, as does a failed
NCCL init.
"""
from __future__ import annotations

import math
import warnings

import torch
import torch.distributed as dist

from ..device import resolve
from ..parallel.sharding import mesh_axis_sizes

__all__ = ["make_host_mesh", "make_production_mesh", "mesh_axis_sizes",
           "n_chips"]


def _ensure_group(device_type: str) -> None:
    """A one-rank default process group where none exists."""
    if dist.is_initialized():
        return
    resolve(device_type)
    if device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)          # the mesh's device, selected
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)


def _take_devices(world: int, n: int, shape, hint: str = ""):
    """The first ``n`` ranks of a ``world``-rank group, shaped ``shape``.

    Under-provision is fatal (a mesh cannot be built).  Over-provision is
    legal but loud: the surplus ranks are left out of the mesh.
    """
    if world < n:
        raise RuntimeError(
            f"need {n} devices for mesh {tuple(shape)}, "
            f"have {world}{hint}")
    if world > n:
        warnings.warn(
            f"mesh {tuple(shape)} uses {n} of {world} devices; "
            f"the remaining {world - n} are idle",
            RuntimeWarning, stacklevel=3)
    return torch.arange(n).reshape(shape)


def _mesh(device_type: str, shape, axes, hint: str = ""):
    from torch.distributed.device_mesh import DeviceMesh

    _ensure_group(device_type)
    ranks = _take_devices(dist.get_world_size(), math.prod(shape), shape,
                          hint)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes,
                 hint="; start the process group with the production "
                      "world size first")


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda"):
    """A (data, model) mesh over the default process group's ranks."""
    return _mesh(device_type, (data, model), ("data", "model"))


def n_chips(mesh) -> int:
    return math.prod(mesh_axis_sizes(mesh).values())

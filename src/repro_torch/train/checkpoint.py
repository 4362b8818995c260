"""Checkpoints with atomic commit, resume, elastic reshard and garbage
collection.

Counterpart of ``repro.train.checkpoint``, with torch tensors as the tree's
leaves and the reference's layout on disk (one directory per step):

    <dir>/step_000123/
        shard_00000.npz     # the tree's leaves, flattened
        manifest.json       # step, leaf shapes/dtypes, extra
    <dir>/LATEST            # atomically-replaced pointer file

Leaves are flattened in the reference's order (``jax.tree.flatten``: dict
keys sorted, tuples and named tuples in order), so ``leaf_00007`` is the
same leaf in both packages.  numpy has no bfloat16, so bf16 (and f16) leaves
are stored widened to f32 (losslessly) and cast back on restore; the
manifest records the stored dtype, as the reference's does.

* **Atomic commit**: leaves are written to ``step_x.tmp/`` and the
  directory is renamed, then ``LATEST`` is replaced via ``os.replace``.  A
  crash mid-write never corrupts the latest checkpoint.
* **Elastic reshard**: checkpoints store *unsharded* leaves (a DTensor
  leaf is gathered whole first, on every rank, and rank 0 writes);
  ``restore(..., shardings=)`` lays them out on whatever mesh the restart
  provides, each rank keeping its own shard, so a job can come back on
  another device count.
* **Garbage collection**: the ``keep_last`` newest steps are kept.
* **Asynchronous writes** (``AsyncCheckpointer``): the tree is copied to
  host memory on the caller's thread, then written and committed on a
  background thread while training goes on.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.sharding import full_value


def flatten(tree) -> list:
    """Leaves in ``jax.tree.flatten`` order; None is an empty subtree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in flatten(t)]
    return [] if tree is None else [tree]


def unflatten(like, leaves: list):
    """A tree shaped like ``like`` with ``leaves`` in ``flatten`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _writer() -> bool:
    """Rank 0 of the default process group (or the only process) writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = full_value(leaf).detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str | Path, step: int, tree: Any, *,
         extra: Optional[Dict[str, Any]] = None, keep_last: int = 3) -> Path:
    """Write one checkpoint atomically.  Returns the committed directory.
    Every rank of a process group calls it (DTensor leaves are gathered);
    only rank 0 writes."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:09d}"
    flat = [_to_numpy(leaf) for leaf in flatten(tree)]
    if not _writer():
        return final
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {}
    meta = []
    for i, arr in enumerate(flat):
        arrays[f"leaf_{i:05d}"] = arr
        meta.append({"shape": list(arr.shape), "dtype": str(arr.dtype)})
    np.savez(tmp / "shard_00000.npz", **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(flat),
        "leaves": meta,
        "time": time.time(),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    os.replace(tmp, final)                      # atomic dir swap

    latest_tmp = ckpt_dir / "LATEST.tmp"
    latest_tmp.write_text(final.name)
    os.replace(latest_tmp, ckpt_dir / "LATEST")  # atomic pointer swap

    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: Path, keep_last: int) -> None:
    steps = sorted(p for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


class AsyncCheckpointer:
    """Overlap checkpoint I/O with the next training steps.

    ``save`` copies the (device) tree to host memory synchronously (cheap,
    and the step may overwrite its buffers), then serializes and commits on
    a background thread.  ``wait`` joins the write in flight; the next
    ``save`` calls it first, so at most one write is in flight.  The atomic
    commit protocol is unchanged: a crash mid-write never corrupts LATEST.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, ckpt_dir: str | Path, step: int, tree: Any, *,
             extra: Optional[Dict[str, Any]] = None,
             keep_last: int = 3) -> None:
        self.wait()
        # a copy: the host view of a CPU tensor shares its storage
        host_tree = unflatten(tree, [np.array(_to_numpy(x))
                                     for x in flatten(tree)])
        if not _writer():
            return

        def _write() -> None:
            try:
                save(ckpt_dir, step, host_tree, extra=extra,
                     keep_last=keep_last)
            except BaseException as e:  # noqa: BLE001 — surfaced in wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    pointer = ckpt_dir / "LATEST"
    if not pointer.exists():
        return None
    name = pointer.read_text().strip()
    if not (ckpt_dir / name / "manifest.json").exists():
        # pointer ahead of a crashed commit: fall back to newest complete dir
        steps = sorted(p.name for p in ckpt_dir.iterdir()
                       if p.is_dir() and (p / "manifest.json").exists())
        if not steps:
            return None
        name = steps[-1]
    return int(name.split("_")[1])


def _flatten_up_to(like, other) -> list:
    """The subtrees of ``other`` at the leaves of ``like``, in ``flatten``
    order (a placements tuple stays one entry)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _flatten_up_to(like[k],
                                                                other[k])]
    if isinstance(like, (tuple, list)):
        return [x for a, b in zip(like, other) for x in _flatten_up_to(a, b)]
    return [] if like is None else [other]


def restore(ckpt_dir: str | Path, like: Any, *, step: Optional[int] = None,
            shardings: Any = None, mesh=None
            ) -> Tuple[int, Any, Dict[str, Any]]:
    """Restore into the structure of ``like``: each leaf takes the dtype and
    device of ``like``'s leaf.  ``shardings`` (a tree of DTensor placements
    shaped like ``like``, e.g. the trainer's placement trees) lays the
    leaves out on ``mesh``, the restart mesh (by default the mesh of
    ``like``'s first DTensor leaf), to reshard elastically; a DTensor leaf
    of ``like`` without one keeps its own mesh and placements.  Returns
    (step, tree, extra)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    src = ckpt_dir / f"step_{step:09d}"
    manifest = json.loads((src / "manifest.json").read_text())
    data = np.load(src / "shard_00000.npz")

    flat_like = flatten(like)
    if len(flat_like) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, the "
                         f"tree {len(flat_like)}")
    flat_sh = (_flatten_up_to(like, shardings) if shardings is not None
               else [None] * len(flat_like))
    if mesh is None:
        mesh = next((r.device_mesh for r in flat_like
                     if isinstance(r, DTensor)), None)
    if shardings is not None and mesh is None:
        raise ValueError("restore(shardings=) needs the restart mesh")
    out = []
    for i, (ref, sh) in enumerate(zip(flat_like, flat_sh)):
        arr = torch.from_numpy(np.asarray(data[f"leaf_{i:05d}"]))
        if isinstance(ref, torch.Tensor):
            arr = arr.to(dtype=ref.dtype, device=ref.device)
        if sh is None and isinstance(ref, DTensor):
            arr = distribute_tensor(arr, ref.device_mesh, ref.placements,
                                    src_data_rank=None)
        elif sh is not None:
            arr = distribute_tensor(arr, mesh, list(sh), src_data_rank=None)
        out.append(arr)
    return step, unflatten(like, out), manifest.get("extra", {})

"""Checkpoints with atomic commit, resume and garbage collection.

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
* **Garbage collection**: the ``keep_last`` newest steps are kept.

The reference's elastic reshard (``shardings``) and its asynchronous writer
wait for meshes (``parallel/``, ROADMAP queue 1).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


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


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str | Path, step: int, tree: Any, *,
         extra: Optional[Dict[str, Any]] = None, keep_last: int = 3) -> Path:
    """Write one checkpoint atomically.  Returns the committed directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = flatten(tree)
    arrays = {}
    meta = []
    for i, leaf in enumerate(flat):
        arr = _to_numpy(leaf)
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


def restore(ckpt_dir: str | Path, like: Any, *, step: Optional[int] = None
            ) -> Tuple[int, Any, Dict[str, Any]]:
    """Restore into the structure of ``like``: each leaf takes the dtype and
    device of ``like``'s leaf.  Returns (step, tree, extra)."""
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
    out = []
    for i, ref in enumerate(flat_like):
        arr = torch.from_numpy(np.asarray(data[f"leaf_{i:05d}"]))
        if isinstance(ref, torch.Tensor):
            arr = arr.to(dtype=ref.dtype, device=ref.device)
        out.append(arr)
    return step, unflatten(like, out), manifest.get("extra", {})

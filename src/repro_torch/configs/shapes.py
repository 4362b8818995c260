"""The four assigned input-shape sets (identical across LM-family archs)."""
from __future__ import annotations

from .base import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# ---------------------------------------------------------------- model zoo
# Representative phases for the model-zoo estimation pipeline
# (core.zoo, DESIGN.md §15): one train step, one prefill, one decode step
# at shapes small enough that every registry architecture compiles on the
# single host device in seconds.  The zoo pairs these with
# ``reduced_config`` (structure-preserving toy width) — the full-size
# sharded cells stay the dry-run's job; the zoo's job is the paper's
# *relative* evaluation of one-node applications across architectures.
ZOO_TRAIN = ShapeConfig(name="zoo_train", seq_len=128, global_batch=2, kind="train")
ZOO_PREFILL = ShapeConfig(name="zoo_prefill", seq_len=256, global_batch=2, kind="prefill")
ZOO_DECODE = ShapeConfig(name="zoo_decode", seq_len=256, global_batch=2, kind="decode")

ZOO_SHAPES = {s.kind: s for s in (ZOO_TRAIN, ZOO_PREFILL, ZOO_DECODE)}
ZOO_PHASES = tuple(ZOO_SHAPES)           # ("train", "prefill", "decode")


def zoo_phases_for(model) -> tuple[str, ...]:
    """Representative phases the zoo traces for ``model`` (every registry
    family supports all three; the hook exists so a future frontend-only
    or encoder-only config can opt out of a phase)."""
    return ZOO_PHASES


def shapes_for(model) -> list[ShapeConfig]:
    """Applicable shapes for a model (long_500k only for sub-quadratic archs)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if model.supports_long_context:
        out.append(LONG_500K)
    return out


def skipped_shapes_for(model) -> list[tuple[ShapeConfig, str]]:
    out = []
    if not model.supports_long_context:
        out.append(
            (
                LONG_500K,
                "full-attention arch: 500k-token KV cache across all layers "
                "exceeds per-chip HBM; assignment says skip for pure "
                "full-attention archs",
            )
        )
    return out

"""Serving: KV-cache sizing, prefill/decode step functions, the engine."""
from .engine import (  # noqa: F401
    Request,
    ServeEngine,
    make_decode_step,
    make_prefill_step,
    sample_logits,
)
from .kvcache import cache_bytes, kv_token_bytes  # noqa: F401

"""Serving engine: prefill/decode step functions + the request loop.

Counterpart of ``repro.serve.engine``.  ``ServeEngine`` prefills each request
on its own, pads the cache's ``kvseq`` axis to ``max_seq`` and then decodes
greedily (or with temperature) one token at a time, as the reference does.
It runs on ``cuda`` unless built with ``device="cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..device import resolve
from ..models import params as pr
from ..models.lm import LM


def sample_logits(logits: torch.Tensor, gen: Optional[torch.Generator], *,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) -> tokens (B,).  temperature 0 = greedy."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    lg = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, -1e30, lg)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


# -------------------------------------------------------------- step functions
def make_prefill_step(model: LM):
    """(params, batch) -> (last-position logits, cache)."""

    def prefill_step(params, batch):
        return model.prefill_fn(params, batch)

    return prefill_step


def make_decode_step(model: LM):
    """(params, cache, batch{tokens(B,1), pos}) -> (next_token, cache)."""

    def decode_step(params, cache, batch):
        logits, new_cache = model.decode_fn(params, cache, batch)
        return torch.argmax(logits, dim=-1), new_cache

    return decode_step


# ------------------------------------------------------------------ the engine
@dataclass
class Request:
    """One generation request (the reference's request record)."""

    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


@dataclass(frozen=True)
class RequestTiming:
    """Host-clock seconds of one request in ``generate``.  Each phase ends
    by reading a token back to the host, which waits for the device."""

    prompt_len: int
    prefill_s: float           # prefill + the first token
    decode_s: float            # every later token
    decode_steps: int


class ServeEngine:
    """Per-request prefill, then cached decode (the reference's loop)."""

    def __init__(self, model: LM, params, *, max_seq: int = 512,
                 temperature: float = 0.0, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve(device)
        for t in pr.leaves(params):
            if t.device.type != self.device.type:
                raise ValueError(f"parameters on {t.device}, engine on "
                                 f"{self.device}")
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.timings: List[RequestTiming] = []

    # -------------------------------------------------------------- prefill
    def _prefill_one(self, prompt: List[int],
                     extra: Optional[Dict[str, Any]] = None):
        toks = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits, cache = self.model.prefill_fn(self.params,
                                              {"tokens": toks, **(extra or {})})
        # grow cache KV seq axis to max_seq so decode can write into it
        return logits, self._pad_cache(cache)

    def _pad_cache(self, cache):
        """Pad the leaves' 'kvseq' axis to ``max_seq``: the k/v of the
        attention families, the hybrid family's shared_k/shared_v.  The SSM
        state and conv windows have no 'kvseq' axis, and whisper's cross
        cache xk/xv is fixed at ``n_frames`` by its spec: they pass through as
        they are.  An int8 model's spec has scale leaves that prefill does
        not return, so its cache is refused here, as in the reference."""
        target = self.max_seq

        def pad_leaf(x, p):
            # The sequence axis is the one the spec declares as 'kvseq'; a
            # scan for an axis sized like the prompt would pad the wrong axis
            # whenever layers, batch or kv heads happen to equal it.
            if "kvseq" not in p.axes:
                return x
            ax = p.axes.index("kvseq")
            if p.shape[ax] != target or x.shape[ax] == target:
                return x
            pad = [0, 0] * (x.dim() - 1 - ax) + [0, target - x.shape[ax]]
            return F.pad(x, pad)

        return pr.tree_map(pad_leaf, cache, self.model.cache_specs(1, target))

    def _next(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_logits(logits, self.gen, temperature=self.temperature)

    # ---------------------------------------------------------------- serve
    @torch.inference_mode()
    def generate(self, prompts: List[List[int]], max_new_tokens: int = 16,
                 extra_inputs: Optional[Dict[str, Any]] = None,
                 eos_id: Optional[int] = None) -> List[List[int]]:
        """Sequentially prefill, then decode each request token by token.
        ``extra_inputs`` go into every prefill's batch beside the tokens:
        ``img_embeds`` (1, n_img_tokens, d) for vlm, ``frames`` (1, n_frames,
        d) for audio, on the engine's device in the parameters' dtype.
        Per-request host-clock times land in ``self.timings``."""
        outs: List[List[int]] = []
        self.timings = []
        for prompt in prompts:
            t0 = time.perf_counter()
            logits, cache = self._prefill_one(prompt, extra_inputs)
            tok = self._next(logits)
            pos = len(prompt)
            toks = [int(tok[0])]
            t1 = time.perf_counter()
            for _ in range(max_new_tokens - 1):
                if eos_id is not None and toks[-1] == eos_id:
                    break
                batch = {"tokens": tok[:, None], "pos": pos}
                logits, cache = self.model.decode_fn(self.params, cache, batch)
                tok = self._next(logits)
                toks.append(int(tok[0]))
                pos += 1
            t2 = time.perf_counter()
            self.timings.append(RequestTiming(len(prompt), t1 - t0, t2 - t1,
                                              len(toks) - 1))
            outs.append(toks)
        return outs

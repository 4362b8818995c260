"""Deterministic synthetic LM token pipeline.

A copy of ``repro.data.synthetic`` (numpy only): the same seed gives the
same batches, bit for bit, in both packages.

Properties a real cluster pipeline needs, kept here at example scale:

* **Deterministic & seekable** — batch ``i`` is a pure function of
  ``(seed, i)``, so restart-from-checkpoint resumes the stream exactly
  (fault tolerance requires the data pipeline to be restartable, not just
  the model state).
* **Per-host sharding** — each host materializes only its slice of the
  global batch (``host_id/n_hosts``); the global batch is assembled by the
  runtime via sharding, never allocated on one host.
* **Prefetch** — a small lookahead queue built on a background thread,
  hiding generation latency behind the step (the paper's SW-prefetch lever
  at the pipeline level).

The token stream is a mixture of structured sequences (ramps, repeats,
n-gram-ish state machines) so a ~100M model trained on it shows a real,
monotonically falling loss — useful for the end-to-end example and the
fault-tolerance tests (loss continuity across restarts).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def _rules(self):
        """Per-DATASET generative rules (fixed across steps, so the model can
        learn them; per-sequence randomness is only in starts/phases)."""
        r = np.random.default_rng(np.random.SeedSequence([self.seed, 9999]))
        return {
            "strides": r.integers(1, 7, size=4),          # ramp strides
            "mult": int(r.integers(2, 6)),                # markov multiplier
            "motifs": [r.integers(0, self.vocab_size, size=p)
                       for p in r.integers(3, 9, size=8)],  # shared motifs
        }

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Batch ``step`` for this host — pure function of (seed, step, host)."""
        rules = self._rules()
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        B, S, V = self.host_batch, self.seq_len, self.vocab_size
        toks = np.empty((B, S), np.int32)
        kind = rng.integers(0, 3, size=B)
        for b in range(B):
            if kind[b] == 0:
                # arithmetic ramp; stride from the dataset's fixed set
                start = int(rng.integers(0, V))
                stride = int(rules["strides"][rng.integers(0, 4)])
                toks[b] = (start + stride * np.arange(S)) % V
            elif kind[b] == 1:
                # one of the dataset's shared motifs, at a random phase
                motif = rules["motifs"][rng.integers(0, len(rules["motifs"]))]
                period = len(motif)
                reps = -(-S // period) + 1
                phase = int(rng.integers(0, period))
                toks[b] = np.tile(motif, reps)[phase:phase + S]
            else:
                # affine markov chain with the dataset's FIXED multiplier:
                # achievable loss ~ ln(3) once f(prev) is learned
                x = np.empty(S, np.int64)
                x[0] = rng.integers(0, V)
                noise = rng.integers(0, 3, size=S)
                for t in range(1, S):
                    x[t] = (rules["mult"] * x[t - 1] + noise[t]) % V
                toks[b] = x
        return {"tokens": toks}


def make_batch_iterator(ds: SyntheticLMDataset, start_step: int = 0,
                        prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Prefetching iterator over batches, resumable at ``start_step``."""
    q: "queue.Queue[Optional[Dict[str, np.ndarray]]]" = queue.Queue(prefetch)
    stop = threading.Event()

    def producer() -> None:
        step = start_step
        while not stop.is_set():
            try:
                q.put(ds.batch(step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()

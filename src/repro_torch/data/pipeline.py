"""Synthetic token data pipeline: deterministic, learnable, prefetched.

The port's copy of ``repro/data/pipeline.py``, verbatim apart from this
paragraph: pure numpy, so ``TokenBatches.batch_at(step)`` gives the
reference's arrays bit for bit.

Sequences are drawn from a fixed sparse Markov chain over the vocabulary
so a language model can actually reduce loss on them (used by the
end-to-end training example), packed to fixed length, and prefetched on
a host thread — the standard input-pipeline shape for TPU training.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class MarkovTokens:
    """Order-1 Markov chain with ``branching`` successors per token."""

    def __init__(self, vocab_size: int, branching: int = 4,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        self.next_tokens = rng.integers(
            0, vocab_size, size=(vocab_size, branching))
        probs = rng.random((vocab_size, branching)) + 0.1
        self.probs = probs / probs.sum(axis=1, keepdims=True)

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, dtype=np.int32)
        t = int(rng.integers(0, self.vocab))
        for i in range(length):
            out[i] = t
            j = rng.choice(self.probs.shape[1], p=self.probs[t])
            t = int(self.next_tokens[t, j])
        return out


class TokenBatches:
    """Deterministic batched (tokens, targets) stream with packing."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, branching: int = 4):
        self.chain = MarkovTokens(vocab_size, branching, seed)
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self._step = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Random-access batch (restart-safe: resume at any step)."""
        rng = np.random.default_rng((self.seed, step))
        toks = np.stack([self.chain.sample(rng, self.seq_len + 1)
                         for _ in range(self.batch)])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = self._step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Host-thread prefetch queue in front of any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

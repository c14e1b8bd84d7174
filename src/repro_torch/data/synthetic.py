"""Synthetic learned-sparse corpus with topical structure (numpy).

A copy of the JAX package's ``data/synthetic.py``: the same seed gives the
same arrays, bit for bit.

MS MARCO + SPLADE are not shippable offline, so benchmarks run on a corpus that
reproduces the *statistics that matter to the algorithm*: Zipfian term frequencies,
log-normal term weights, topical clusterability (so similarity-based block formation
has signal), and SPLADE-like doc/query lengths. Ground truth = exact dot-product top-k
(the rank-safe oracle), matching the paper's "preserved recall" protocol.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np


@dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 65536
    vocab: int = 4096
    n_topics: int = 64
    doc_len_mean: int = 48  # SPLADE passage expansions average ~ tens of terms
    query_len_mean: int = 24
    topic_concentration: float = 0.25  # fraction of doc terms drawn from its topic
    seed: int = 0


class Corpus(NamedTuple):
    doc_ptr: np.ndarray  # int64 [n_docs+1]
    tids: np.ndarray  # int32 [nnz]
    ws: np.ndarray  # float32 [nnz]
    vocab: int
    doc_topic: np.ndarray  # int32 [n_docs]


def _zipf_probs(v: int, a: float = 1.07) -> np.ndarray:
    p = 1.0 / np.arange(1, v + 1) ** a
    return p / p.sum()


def make_corpus(cfg: CorpusConfig) -> Corpus:
    rng = np.random.default_rng(cfg.seed)
    base = _zipf_probs(cfg.vocab)
    perm = rng.permutation(cfg.vocab)
    base = base[perm]
    # each topic boosts a random subset of terms
    topic_terms = rng.integers(0, cfg.vocab, size=(cfg.n_topics, max(cfg.vocab // 32, 8)))

    doc_topic = rng.integers(0, cfg.n_topics, cfg.n_docs).astype(np.int32)
    lens = np.clip(rng.poisson(cfg.doc_len_mean, cfg.n_docs), 4, None).astype(np.int64)
    ptr = np.zeros(cfg.n_docs + 1, np.int64)
    np.cumsum(lens, out=ptr[1:])
    nnz = int(ptr[-1])

    n_topical = (lens * cfg.topic_concentration).astype(np.int64)
    tids = np.empty(nnz, np.int32)
    # vectorized fill: global background terms for all slots, then overwrite topical ones
    tids[:] = rng.choice(cfg.vocab, size=nnz, p=base).astype(np.int32)
    slot_doc = np.repeat(np.arange(cfg.n_docs), lens)
    slot_rank = np.arange(nnz) - ptr[slot_doc]
    topical = slot_rank < n_topical[slot_doc]
    rows = doc_topic[slot_doc[topical]]  # each topical slot's topic, then a draw from its terms
    tids[topical] = topic_terms[rows, rng.integers(0, topic_terms.shape[1], rows.shape[0])]

    ws = rng.lognormal(mean=0.0, sigma=0.7, size=nnz).astype(np.float32)
    # dedup term ids within a doc (keep max weight) for a well-formed sparse vector
    key = slot_doc.astype(np.int64) * cfg.vocab + tids
    order = np.lexsort((-ws, key))
    key_s, ws_s = key[order], ws[order]
    first = np.ones(nnz, bool)
    first[1:] = key_s[1:] != key_s[:-1]
    key_u, ws_u = key_s[first], ws_s[first]
    doc_u = (key_u // cfg.vocab).astype(np.int64)
    tid_u = (key_u % cfg.vocab).astype(np.int32)
    new_lens = np.bincount(doc_u, minlength=cfg.n_docs).astype(np.int64)
    new_ptr = np.zeros(cfg.n_docs + 1, np.int64)
    np.cumsum(new_lens, out=new_ptr[1:])
    return Corpus(new_ptr, tid_u, ws_u.astype(np.float32), cfg.vocab, doc_topic)


def make_queries(
    cfg: CorpusConfig, corpus: Corpus, n_queries: int, seed: int = 1
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Queries share the corpus's topical structure (so pruning heuristics see the
    same bound-tightness regime as Figure 1 of the paper)."""
    rng = np.random.default_rng(seed)
    out = []
    base = _zipf_probs(cfg.vocab)
    for _ in range(n_queries):
        topic = rng.integers(0, cfg.n_topics)
        ln = max(4, int(rng.poisson(cfg.query_len_mean)))
        # half topical: sample terms from a random doc of this topic
        cand_docs = np.flatnonzero(corpus.doc_topic == topic)
        d = rng.choice(cand_docs) if len(cand_docs) else rng.integers(0, len(corpus.doc_ptr) - 1)
        dts = corpus.tids[corpus.doc_ptr[d] : corpus.doc_ptr[d + 1]]
        n_top = min(ln // 2, len(dts))
        t_topical = rng.choice(dts, n_top, replace=False) if n_top else np.empty(0, np.int32)
        t_bg = rng.choice(cfg.vocab, ln - n_top, p=base).astype(np.int32)
        tids = np.unique(np.concatenate([t_topical, t_bg]).astype(np.int32))
        ws = rng.lognormal(0.0, 0.7, len(tids)).astype(np.float32)
        out.append((tids, ws))
    return out

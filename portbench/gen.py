"""Seeded synthetic learned-sparse corpus and queries, drawn on the device.

The statistics of the port's ``data/synthetic.py`` (numpy, on the host),
drawn with a ``torch.Generator`` on the run's device in a few large calls:

* documents: length Poisson(``doc_len_mean``) clipped below at 4; each slot a
  background term from a Zipf(``zipf_a``) law over a seeded permutation of
  the vocabulary, except the first ``topic_concentration`` share of slots,
  which draw from the ``vocab // 32`` boosted terms of the document's topic;
  weights log-normal(0, ``weight_sigma``); a term repeated in a document
  keeps its largest weight, and each document's terms are in ascending id;
* queries: a random topic, length Poisson(``query_len_mean``) clipped at 4;
  half the terms drawn without replacement from a random document of that
  topic, the rest from the Zipf law over the *unpermuted* vocabulary (as
  ``data/synthetic.py`` draws them), duplicates merged; weights log-normal.

Which terms are frequent and which terms each topic boosts are the
deployment's language, drawn once from a fixed stream, as MS MARCO's
vocabulary statistics are fixed; the seed draws the documents and queries.
So every seed gives a corpus of the same statistics, and the work a query
costs does not hinge on which terms a seed happened to make frequent. The
same seed gives the same arrays on the same kind of device. Nothing is
written to disk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


@dataclass(frozen=True)
class CorpusSpec:
    n_docs: int
    vocab: int
    n_topics: int
    doc_len_mean: float = 48.0
    query_len_mean: float = 24.0
    topic_concentration: float = 0.25
    zipf_a: float = 1.07
    weight_sigma: float = 0.7

    @classmethod
    def from_config(cls, cfg: dict) -> "CorpusSpec":
        c = cfg["corpus"]
        return cls(**{k: c[k] for k in cls.__dataclass_fields__ if k in c})


class Corpus(NamedTuple):
    doc_ptr: torch.Tensor  # int64 [n_docs + 1]
    tids: torch.Tensor  # int32 [nnz], ascending within a document
    ws: torch.Tensor  # float32 [nnz]
    doc_topic: torch.Tensor  # int64 [n_docs]
    vocab: int


class Queries(NamedTuple):
    tids: np.ndarray  # int32 [n, width], ascending, padded with vocab
    ws: np.ndarray  # float32 [n, width], 0 in padding
    lens: np.ndarray  # int64 [n]

    def __len__(self) -> int:
        return len(self.lens)

    def get(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        n = self.lens[i]
        return self.tids[i, :n], self.ws[i, :n]


def stream(seed: int, salt: int) -> int:
    """A sub-seed of ``seed`` for one use (corpus, queries, sample, ...)."""
    return (int(seed) * 1_000_003 + salt * 7_919) % (2**63 - 1)


def generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, salt))


def zipf_cdf(vocab: int, a: float, device) -> torch.Tensor:
    p = torch.arange(1, vocab + 1, dtype=torch.float64, device=device).pow(-a)
    cdf = torch.cumsum(p, 0)
    return cdf / cdf[-1]


def _draw(cdf: torch.Tensor, n: int, g: torch.Generator) -> torch.Tensor:
    """n ranks of the law whose CDF is ``cdf`` (int64)."""
    u = torch.rand(n, generator=g, dtype=torch.float64, device=cdf.device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)


LANGUAGE_SEED = 0  # the vocabulary's term frequencies and topics: the deployment's, fixed


def shard_range(n_docs: int, shard) -> tuple[int, int]:
    """The documents [lo, hi) of rank r of P (``shard`` = (r, P)): contiguous
    cuts of ceil(n_docs / P), the last one shorter; all of them for None."""
    if shard is None:
        return 0, n_docs
    r, p = shard
    size = -(-n_docs // p)
    lo = min(n_docs, r * size)
    return lo, min(n_docs, lo + size)


class _Slots(NamedTuple):
    """Every random draw of one corpus, before a document's repeated terms are
    merged: what fixes the corpus, whichever documents are kept of it."""

    doc_topic: torch.Tensor  # int64 [n_docs]
    ptr: torch.Tensor  # int64 [n_docs + 1] slot offsets
    slot_doc: torch.Tensor  # int64 [slots]
    tids: torch.Tensor  # int64 [slots]
    ws: torch.Tensor  # float32 [slots]


def _draw_slots(spec: CorpusSpec, seed: int, device) -> _Slots:
    v, n = spec.vocab, spec.n_docs
    lang = generator(LANGUAGE_SEED, 0, device)
    perm = torch.randperm(v, generator=lang, device=device)
    topic_terms = torch.randint(0, v, (spec.n_topics, max(v // 32, 8)), generator=lang, device=device)
    g = generator(seed, 1, device)
    doc_topic = torch.randint(0, spec.n_topics, (n,), generator=g, device=device)
    rate = torch.full((n,), float(spec.doc_len_mean), dtype=torch.float32, device=device)
    lens = torch.poisson(rate, generator=g).clamp_(min=4).long()
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    ptr[1:] = torch.cumsum(lens, 0)
    nnz = int(ptr[-1])

    slot_doc = torch.repeat_interleave(torch.arange(n, device=device), lens)
    slot_rank = torch.arange(nnz, device=device) - ptr[slot_doc]
    n_topical = (lens.double() * spec.topic_concentration).long()
    tids = perm[_draw(zipf_cdf(v, spec.zipf_a, device), nnz, g)]
    topical = slot_rank < n_topical[slot_doc]
    rows = doc_topic[slot_doc[topical]]
    pick = torch.randint(0, topic_terms.shape[1], (rows.numel(),), generator=g, device=device)
    tids[topical] = topic_terms[rows, pick]
    ws = torch.exp(spec.weight_sigma * torch.randn(nnz, generator=g, device=device))
    return _Slots(doc_topic, ptr, slot_doc, tids, ws)


def _merge(slot_doc: torch.Tensor, tids: torch.Tensor, ws: torch.Tensor, n: int, v: int):
    """One (document, term) pair each, keeping its largest weight, for the
    slots of documents 0..n-1 (``slot_doc``): (doc_ptr, tids, ws). Each
    document's result depends on its own slots only."""
    device = tids.device
    nnz = tids.numel()
    key = slot_doc * v + tids
    order = torch.argsort(-ws, stable=True)
    order = order[torch.argsort(key[order], stable=True)]
    key_s, ws_s = key[order], ws[order]
    first = torch.ones(nnz, dtype=torch.bool, device=device)
    first[1:] = key_s[1:] != key_s[:-1]
    key_u, ws_u = key_s[first], ws_s[first]
    doc_u = key_u // v
    new_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    new_ptr[1:] = torch.cumsum(torch.bincount(doc_u, minlength=n), 0)
    return new_ptr, (key_u % v).to(torch.int32), ws_u.float().contiguous()


def make_corpus(spec: CorpusSpec, seed: int, device, shard=None) -> Corpus:
    """The corpus of ``spec`` drawn from ``seed``; with ``shard`` = (r, P),
    rank r's documents of it (``shard_range``), numbered from 0: the P
    slices together are the corpus drawn without ``shard``, bit for bit."""
    s = _draw_slots(spec, seed, device)
    lo, hi = shard_range(spec.n_docs, shard)
    if (lo, hi) == (0, spec.n_docs):
        ptr, tids, ws = _merge(s.slot_doc, s.tids, s.ws, spec.n_docs, spec.vocab)
        return Corpus(ptr, tids, ws, s.doc_topic, spec.vocab)
    a, b = int(s.ptr[lo]), int(s.ptr[hi])
    slot_doc, tids, ws = s.slot_doc[a:b] - lo, s.tids[a:b].clone(), s.ws[a:b].clone()
    doc_topic = s.doc_topic[lo:hi].clone()
    del s
    ptr, tids, ws = _merge(slot_doc, tids, ws, hi - lo, spec.vocab)
    return Corpus(ptr, tids, ws, doc_topic, spec.vocab)


def _documents(spec: CorpusSpec, s: _Slots, docs: torch.Tensor) -> Corpus:
    """The documents ``docs`` (ascending, distinct) of the corpus whose draws
    are ``s``, as a corpus numbered 0..len(docs)-1."""
    keep = torch.isin(s.slot_doc, docs)
    slot_doc = torch.searchsorted(docs, s.slot_doc[keep])
    ptr, tids, ws = _merge(slot_doc, s.tids[keep], s.ws[keep], docs.numel(), spec.vocab)
    return Corpus(ptr, tids, ws, s.doc_topic[docs], spec.vocab)


def make_queries(spec: CorpusSpec, corpus: Corpus, n: int, seed: int, salt: int = 2, shard=None) -> Queries:
    """``n`` queries of ``corpus``'s topics, on its device, returned on the host.
    With ``shard`` = (r, P), ``corpus`` is rank r's slice and the queries are
    those of the whole corpus, the same on every rank: their documents are
    drawn over every slice, and drawn again here from ``seed``."""
    device = corpus.tids.device
    slots = None
    if shard_range(spec.n_docs, shard) != (0, spec.n_docs):
        slots = _draw_slots(spec, seed, device)
        corpus = corpus._replace(doc_topic=slots.doc_topic)
    g = generator(seed, salt, device)
    v = spec.vocab
    topic = torch.randint(0, spec.n_topics, (n,), generator=g, device=device)
    rate = torch.full((n,), float(spec.query_len_mean), dtype=torch.float32, device=device)
    ln = torch.poisson(rate, generator=g).clamp_(min=4).long()

    # a random document of the query's topic (any document if the topic has none)
    by_topic = torch.argsort(corpus.doc_topic, stable=True)
    counts = torch.bincount(corpus.doc_topic, minlength=spec.n_topics)
    starts = torch.cumsum(counts, 0) - counts
    u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
    any_doc = torch.randint(0, spec.n_docs, (n,), generator=g, device=device)
    cnt = counts[topic]
    off = (u * cnt.double()).long().clamp_(max=(cnt - 1).clamp(min=0))
    doc = torch.where(cnt > 0, by_topic[(starts[topic] + off).clamp(max=spec.n_docs - 1)], any_doc)
    if slots is not None:  # the chosen documents of the whole corpus, drawn again
        docs, doc = torch.unique(doc, return_inverse=True)
        corpus = _documents(spec, slots, docs)
        del slots
    d0 = corpus.doc_ptr[doc]
    dlen = corpus.doc_ptr[doc + 1] - d0
    n_top = torch.minimum(ln // 2, dlen)

    # topical terms: n_top distinct slots of the document, by random keys
    t_max = int(dlen.max())
    slots = torch.arange(t_max, device=device)
    keys = torch.rand(n, t_max, generator=g, device=device)
    keys = torch.where(slots[None, :] < dlen[:, None], keys, 2.0)
    chosen = torch.argsort(keys, dim=1)
    take = slots[None, :] < n_top[:, None]
    top_t = corpus.tids[(d0[:, None] + chosen).clamp(max=corpus.tids.numel() - 1)].long()
    top_t = torch.where(take, top_t, v)

    # background terms from the unpermuted Zipf law
    l_max = int(ln.max())
    bg = _draw(zipf_cdf(v, spec.zipf_a, device), n * l_max, g).view(n, l_max)
    bg = torch.where(torch.arange(l_max, device=device)[None, :] < (ln - n_top)[:, None], bg, v)

    terms = torch.sort(torch.cat([top_t, bg], dim=1), dim=1).values
    dup = torch.zeros_like(terms, dtype=torch.bool)
    dup[:, 1:] = terms[:, 1:] == terms[:, :-1]
    terms = torch.sort(torch.where(dup, v, terms), dim=1).values
    lens = (terms < v).sum(dim=1)
    width = int(lens.max())
    terms = terms[:, :width]
    ws = torch.exp(spec.weight_sigma * torch.randn(n, width, generator=g, device=device))
    ws = torch.where(terms < v, ws, 0.0)
    return Queries(terms.to(torch.int32).cpu().numpy(), ws.float().cpu().numpy(), lens.cpu().numpy())


def corpus_to_host(corpus: Corpus) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(doc_ptr, tids, ws, vocab) as host numpy arrays: what the program's
    index build takes."""
    return (corpus.doc_ptr.cpu().numpy(), corpus.tids.cpu().numpy(), corpus.ws.cpu().numpy(), corpus.vocab)

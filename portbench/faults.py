"""The control and the faults that the check has to catch, planted under a
run's timed path (``harness.run(..., fault=<one of these>)``).

* ``control``: the reference in bfloat16, the nearest precision below the
  configuration's float32, put in the program's place;
* ``alter_answer``: every response's best document replaced by the next
  document id, its score kept, where the result is produced;
* ``half_batch``: each batch computes its first half and hands the second
  half the first half's results;
* ``stale_index``: the index build leaves the block bounds as they started
  (zero), a step that returns its state unchanged;
* ``shuffled_order``: the index built with a seeded random document order in
  place of the program's clustering, every later stage sound: what the
  check's recall against exhaustive scoring has to catch.

``python3 portbench/control.py`` reads the control at a cell's own size.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import gen
from portbench.reference import lsp as ref_lsp


def _wrap_results(ctx, fn):
    """Put ``fn(queries) -> (ids [Q, k], scores [Q, k])`` (host tensors) in
    the timed path, in place of ``search_batch``."""
    from repro_torch.api import SearchResponse

    def search_batch(reqs):
        ids, scores = fn([(np.asarray(t), np.asarray(w)) for t, w in reqs])
        return [SearchResponse(doc_ids=ids[i].numpy().astype(np.int32), scores=scores[i].numpy())
                for i in range(len(reqs))]

    ctx.retr.search_batch = search_batch


def control(ctx) -> None:
    cfg = ctx.cfg
    ix, q = cfg["index"], cfg["query"]
    corpus = ctx.corpus
    rows = torch.arange(corpus.vocab)
    ref = ref_lsp.derive(corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab, ctx.retr.index.doc_remap, ix["b"],
                         ix["c"], ix["bound_bits"], ix["doc_bits"], rows)

    def fn(queries):
        return ref_lsp.search(ref, queries, k=q["k"], gamma=q["gamma"], gamma0=q["gamma0"], beta=q["beta"],
                              eta=q["eta"], dtype=torch.bfloat16)

    _wrap_results(ctx, fn)


def alter_answer(ctx) -> None:
    n_docs = ctx.corpus.doc_ptr.numel() - 1
    inner = ctx.retr.search_batch

    def search_batch(reqs):
        out = inner(reqs)
        for r in out:
            r.doc_ids[0] = (r.doc_ids[0] + 1) % n_docs
        return out

    ctx.retr.search_batch = search_batch


def half_batch(ctx) -> None:
    inner = ctx.retr.search_batch

    def search_batch(reqs):
        half = max(1, len(reqs) // 2)
        out = inner(reqs[:half])
        return (out * 2)[: len(reqs)]

    ctx.retr.search_batch = search_batch


def stale_index(ctx) -> None:
    ctx.retr.index.blk_bounds.packed.zero_()


def shuffled_order(ctx) -> None:
    from portbench import harness
    from repro_torch.index import clustering

    def random_order(doc_ptr, tids, ws, vocab, b, c, *args, device, **kw):
        n = len(doc_ptr) - 1
        g = gen.generator(ctx.seed, 11, device)
        order = torch.randperm(n, generator=g, device=device)
        fill = torch.full(((-n) % (b * c),), n, dtype=order.dtype, device=device)
        return torch.cat([order, fill]).to(torch.int32)

    del ctx.retr
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    real = clustering.block_order
    clustering.block_order = random_order
    try:
        ctx.retr = harness.build_retriever(ctx.cfg, gen.corpus_to_host(ctx.corpus), ctx.device)
    finally:
        clustering.block_order = real


FAULTS = {"control": control, "alter_answer": alter_answer, "half_batch": half_batch, "stale_index": stale_index,
          "shuffled_order": shuffled_order}

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

Those act on rank 0. Of a cell on several ranks (each called on every rank,
on the others before they follow, and acting where it names):

* ``stale_shard``: rank 1's shard served with its block bounds as they
  started (zero);
* ``no_exchange``: every rank's traversal merges its own shard's candidates
  in place of every rank's, the exchange between cards left out;
* ``kill_rank``: rank 1 killed at its fifth search, inside the window.

``python3 portbench/control.py`` reads the control at a cell's own size.
"""

from __future__ import annotations

import gc
import os
import signal

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
    if ctx.rank:
        return
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
    if ctx.rank:
        return
    n_docs = ctx.corpus.doc_ptr.numel() - 1
    inner = ctx.retr.search_batch

    def search_batch(reqs):
        out = inner(reqs)
        for r in out:
            r.doc_ids[0] = (r.doc_ids[0] + 1) % n_docs
        return out

    ctx.retr.search_batch = search_batch


def half_batch(ctx) -> None:
    if ctx.rank:
        return
    inner = ctx.retr.search_batch

    def search_batch(reqs):
        half = max(1, len(reqs) // 2)
        out = inner(reqs[:half])
        return (out * 2)[: len(reqs)]

    ctx.retr.search_batch = search_batch


def stale_index(ctx) -> None:
    if ctx.rank:
        return
    ctx.retr.index.blk_bounds.packed.zero_()


def shuffled_order(ctx) -> None:
    from portbench.builds import local
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
        ctx.retr = local.build_retriever(ctx.cfg, gen.corpus_to_host(ctx.corpus), ctx.device)
    finally:
        clustering.block_order = real


def stale_shard(ctx) -> None:
    if ctx.rank != 1:
        return
    from repro_torch.serve import group

    real = group._open_local

    def open_stale(*args, **kw):
        local, failed = real(*args, **kw)
        if local is not None:
            local.shards[ctx.rank].blk_bounds.packed.zero_()
        return local, failed

    group._open_local = open_stale


def no_exchange(ctx) -> None:
    from repro_torch.distributed import sharded

    def own_only(t, group=None):
        return torch.cat([t] * torch.distributed.get_world_size(group), dim=1)

    sharded.all_gather_cat = own_only


no_exchange.early = True  # on every rank from the start, so the ranks' exchanges stay in step


def kill_rank(ctx) -> None:
    if ctx.rank != 1:
        return
    from repro_torch.distributed.sharded import ShardedRetriever

    real = ShardedRetriever.__call__
    calls = []

    def call(self, *args, **kw):
        calls.append(1)
        if len(calls) == 5:
            os.kill(os.getpid(), signal.SIGKILL)
        return real(self, *args, **kw)

    ShardedRetriever.__call__ = call


FAULTS = {"control": control, "alter_answer": alter_answer, "half_batch": half_batch, "stale_index": stale_index,
          "shuffled_order": shuffled_order, "stale_shard": stale_shard, "no_exchange": no_exchange,
          "kill_rank": kill_rank}

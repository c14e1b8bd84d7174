"""Closed loop, one caller: ``Retriever.search_batch`` of ``batch`` distinct
queries a call, back to back, for the whole window.

Mix parameters: ``batch`` (queries a call), ``max_qps`` (sizes the query
pool to ``max_qps`` x the window; past it the pool wraps and a line says so),
``warmup_calls``. Every response is kept; the check takes the cell's
``check.sample`` of them, drawn from the seed once the window has closed.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np

from portbench import gen
from portbench.harness import log


def prepare(ctx) -> None:
    mix = ctx.mix
    batch = mix["batch"]
    n = batch * max(1, math.ceil(mix["max_qps"] * ctx.seconds / batch))
    t0 = time.perf_counter()
    ctx.pool = gen.make_queries(ctx.spec, ctx.corpus, n, ctx.seed, salt=2, shard=ctx.shard)
    reqs = [ctx.pool.get(i) for i in range(n)]
    ctx.batches = [reqs[lo : lo + batch] for lo in range(0, n, batch)]  # the calls' arguments, made before the window
    warm = gen.make_queries(ctx.spec, ctx.corpus, mix["batch"] * mix["warmup_calls"], ctx.seed, salt=3,
                            shard=ctx.shard)
    t1 = time.perf_counter()
    for c in range(mix["warmup_calls"]):
        ctx.retr.search_batch([warm.get(i) for i in range(c * mix["batch"], (c + 1) * mix["batch"])])
    k = ctx.cfg["query"]["k"]
    ctx.ids = np.empty((n, k), np.int32)
    ctx.scores = np.empty((n, k), np.float32)
    ctx.got = np.zeros(n, bool)
    log(f"set-up: {n} pool queries {t1 - t0:.3f} s, {mix['warmup_calls']} warm-up calls "
        f"{time.perf_counter() - t1:.3f} s")


def window(ctx) -> SimpleNamespace:
    pool, batch, retr, batches = ctx.pool, ctx.mix["batch"], ctx.retr, ctx.batches
    n = len(pool)
    calls = answered = failed = 0
    ends = []
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        c = (answered + failed) // batch % len(batches)
        try:
            resps = retr.search_batch(batches[c])
        except RuntimeError:
            failed += batch
            continue
        lo = c * batch
        ctx.ids[lo : lo + batch] = np.stack([r.doc_ids for r in resps])
        ctx.scores[lo : lo + batch] = np.stack([r.scores for r in resps])
        ctx.got[lo : lo + batch] = True
        answered += batch
        calls += 1
        ends.append(time.perf_counter())
    window_s = time.perf_counter() - t0
    sent = answered + failed
    rng = np.random.default_rng(gen.stream(ctx.seed, 5))
    done = np.flatnonzero(ctx.got)
    chosen = np.sort(rng.choice(done, size=min(done.size, ctx.cell["check"]["sample"]), replace=False))
    notes = [f"bulk: {calls} calls of {batch}, {answered} queries answered, {failed} failed, in {window_s:.4f} s"]
    per_s = np.bincount((np.asarray(ends) - t0).astype(int), minlength=int(ctx.seconds))
    notes.append(f"bulk: calls ended in each second of the window: {per_s.tolist()}")
    if sent > n:
        notes.append(f"bulk: the pool of {n} queries wrapped ({sent} sent)")
    return SimpleNamespace(answered=answered, attempted=sent, failed=failed, window_s=window_s, calls=calls,
                           notes=notes, sample_queries=[pool.get(i) for i in chosen],
                           sample_responses=[(ctx.ids[i], ctx.scores[i]) for i in chosen])


def stop(ctx) -> None:
    pass

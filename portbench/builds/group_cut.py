"""A shard set cut from one whole index, served through the program's
process-group front end (backend ``shard_map``): rank 0 gathers every rank's
slice of the corpus, builds the index of the whole corpus as ``local`` does,
and saves it cut into one shard a rank (``index.store.save_sharded_index``)
under a directory of the run's own; rank 0's ``serve.group.GroupFrontEnd``
opens it, every rank loads its own shard, and each ``search_batch`` of rank
0 drives every rank's ``Follower``.

The whole index has to fit rank 0's card, so this stands in for builds of
one slice a rank at the sizes where it does (the benchmark's tests)."""

from __future__ import annotations

import shutil
import tempfile

import numpy as np
import torch.distributed as dist

from portbench import gen
from portbench.builds import local


def _whole_corpus(ctx, group):
    """Every rank's slice, gathered on rank 0 as one host corpus (doc_ptr,
    tids, ws, vocab); None on the others."""
    parts = [None] * group.size if group.rank == 0 else None
    dist.gather_object(gen.corpus_to_host(ctx.corpus), parts, dst=0, group=group.gloo)
    if group.rank:
        return None
    offsets = np.cumsum([0] + [len(p[1]) for p in parts[:-1]])
    doc_ptr = np.concatenate([parts[0][0][:1]] + [p[0][1:] + o for p, o in zip(parts, offsets)])
    return doc_ptr, np.concatenate([p[1] for p in parts]), np.concatenate([p[2] for p in parts]), ctx.corpus.vocab


def build(ctx, group):
    from repro_torch.index.store import save_sharded_index
    from repro_torch.serve.group import GroupFrontEnd

    whole = local.build_retriever(ctx.cfg, _whole_corpus(ctx, group), ctx.device)
    ctx.shard_dir = tempfile.mkdtemp(prefix="portbench-shards-")
    save_sharded_index(ctx.shard_dir, whole.index, group.size)
    del whole
    group.built()
    ctx.front = GroupFrontEnd(group.program, ctx.device)
    scfg, params = local.query_point(ctx.cfg)
    return ctx.front.open(ctx.shard_dir, scfg, params)


def follow(ctx, group):
    from repro_torch.serve.group import Follower

    _whole_corpus(ctx, group)
    group.built()
    follower = Follower(group.program, ctx.device)
    while True:
        kind = follower.step()
        if kind == "open":  # the set it serves: its shard is judged once rank 0 closes
            ctx.retr = next(reversed(follower.sets.values()))
        elif kind == "shutdown":
            return


def close(ctx, group):
    ctx.front.close()
    shutil.rmtree(ctx.shard_dir, ignore_errors=True)


def leaves(ctx, group) -> dict:
    held = ctx.retr.index if group.rank == 0 else ctx.retr  # a Retriever over a ShardedIndex; a ShardedRetriever
    return local.port_leaves(held.shards[group.rank])

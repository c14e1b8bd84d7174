"""Plain PyTorch reference of the check of a cell whose program serves a
shard set, one shard a rank: ``check`` runs on every rank of the run's
group, and rank 0 gets the compared numbers.

A shard is a contiguous run of superblocks of one document order over the
whole corpus, its documents under their global ids, each term's bound rows
quantized on the scale of the whole corpus. Every rank draws the whole
corpus again from the seed (``gen.make_corpus``), takes every rank's
document order (``doc_remap``, padded with ``n_docs`` at each shard's tail),
and derives the index of the union of the shards (``lsp.derive``). Then:

* each rank holds its own shard to its part of the union's derivation
  (``index_mismatches``, summed over the ranks), and the union's order to its
  form (``shard_order_mismatches``);
* rank 0 holds the sampled responses to LSP/0 over the union, and to
  exhaustive scoring of the whole corpus (``lsp.judge_responses``): the
  sharded traversal equals the traversal of the union.

It imports torch, numpy and the benchmark's generator, nothing of the
program; ``group`` is the run's (``rank``, ``size``, and ``gloo``, a gloo
process group over its ranks).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from portbench import gen
from portbench.reference import lsp


def shard_order_mismatches(remaps: list, n_docs: int, b: int, c: int) -> int:
    """Positions at which the shards' document orders (one a rank, in rank
    order) break their contract: each a length of whole superblocks, the
    sentinel ``n_docs`` only after its last document, and every document in
    exactly one shard, once."""
    bad = 0
    heads = []
    for remap in remaps:
        remap = remap.long()
        if remap.numel() % (b * c):
            bad += remap.numel() % (b * c)
        real = (remap >= 0) & (remap < n_docs)
        n_real = int(real.sum())
        bad += int((~real[:n_real]).sum())  # padding, or an id out of range, before the last document
        bad += int((remap[n_real:] != n_docs).sum())
        heads.append(remap[real])
    head = torch.cat(heads) if heads else torch.empty(0, dtype=torch.int64)
    seen = torch.bincount(head, minlength=n_docs)
    return bad + int((seen != 1).sum())


def _part(ref: lsp.RefIndex, p0: int, n_pos: int) -> lsp.RefIndex:
    """The positions [p0, p0 + n_pos) of ``ref``, whole superblocks, as the
    index a shard holds."""
    b, per_sb = ref.b, ref.b * ref.c
    return ref._replace(n_blocks=n_pos // b, n_sb=n_pos // per_sb, remap=ref.remap[p0: p0 + n_pos],
                        fw_tids=ref.fw_tids[p0: p0 + n_pos], fw_q=ref.fw_q[p0: p0 + n_pos],
                        blk_scale=ref.blk_scale[p0 // b: (p0 + n_pos) // b],
                        blk_lvl=ref.blk_lvl[:, p0 // b: (p0 + n_pos) // b],
                        sb_lvl=ref.sb_lvl[:, p0 // per_sb: (p0 + n_pos) // per_sb])


def check(cell: dict, cfg: dict, corpus, leaves: dict, queries: list, responses: list, seed: int,
          group) -> dict:
    """On every rank of ``group``: ``corpus`` and ``leaves`` are the rank's
    slice and the leaves of the shard it served; ``queries`` and
    ``responses`` rank 0's sample (the others pass anything). Returns the
    compared numbers on rank 0, the rank's own on the others."""
    ix = cfg["index"]
    spec = gen.CorpusSpec.from_config(cfg)
    device = corpus.tids.device
    size, rank = group.size, group.rank
    box = [(queries, responses)]
    remaps = [leaves["remap"].cpu()]
    if size > 1:
        dist.broadcast_object_list(box, src=0, group=group.gloo)
        remaps = [None] * size
        dist.all_gather_object(remaps, leaves["remap"].cpu(), group=group.gloo)
    queries, responses = box[0]
    nums = {"index_mismatches": shard_order_mismatches(remaps, spec.n_docs, ix["b"], ix["c"])}
    ref = whole = None
    if nums["index_mismatches"] == 0:
        whole = gen.make_corpus(spec, seed, device)
        rows = lsp.check_rows(cell, spec.vocab, queries, seed)
        ref = lsp.derive(whole.doc_ptr, whole.tids, whole.ws, spec.vocab, torch.cat(remaps).to(device), ix["b"],
                         ix["c"], ix["bound_bits"], ix["doc_bits"], rows)
        p0 = sum(r.numel() for r in remaps[:rank])
        nums["index_mismatches"] = lsp.index_mismatches(_part(ref, p0, remaps[rank].numel()), leaves)
    if size > 1:
        counts = [None] * size
        dist.all_gather_object(counts, nums["index_mismatches"], group=group.gloo)
        if rank == 0:
            lsp.log(f"index_mismatches by rank: {counts}")
        nums["index_mismatches"] = sum(counts)
    if rank == 0:
        if ref is None:
            nums.update(lsp.UNJUDGED)
        else:
            nums.update(lsp.judge_responses(ref, cfg, whole, queries, responses))
    return nums

"""Plain PyTorch reference of the benchmark's check.

It imports torch and numpy only. From the generated corpus and queries it
works out again what the program derived and produced:

* the quantized index the traversal reads: per-term block and superblock
  maximum weights rounded up to ``bound_bits`` levels of a per-row scale,
  and the documents' weights rounded to ``doc_bits`` levels of a per-block
  scale, laid out block by block;
* the LSP/0 traversal (the paper's Algorithm 1 with its two rounds): β
  query pruning for the bounds, the top-γ superblocks by SBMax (ties by
  lower superblock), round 0 over the first γ₀ of them to seed θ (the k-th
  best score), the rest kept where SBMax >= θ, their blocks kept where the
  block bound > θ/η, and the (score desc, id asc) top-k of every scored
  document.

One stage it takes from the program instead: the order of documents into
blocks (``doc_remap``). The program's k-means sums with atomics on the card,
so its clusters cannot be worked out again bit for bit. That stage is checked
by itself: ``order_mismatches`` holds it to its form (every document once,
in whole superblocks, padded at the tail), and ``recall_shortfall`` against
``exhaustive_topk``, the top-k of every document, to its purpose: an order
that groups documents no better than chance leaves the bounds loose, and
the top-γ superblocks miss many of the best documents where k is large.

``dtype`` selects the precision of the bounds and scores: float32 is the
configuration's; bfloat16 is the control, the nearest precision below it.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

NEG = -1e30


def align_up(n: int, multiple: int) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def unpack(words: torch.Tensor, bits: int, granule: int, n: int) -> torch.Tensor:
    """int32 words [R, W] in the lane-strided layout (value v of segment s at
    word s*G + v % G, bit-lane v // G) -> levels int32 [R, n]."""
    vpw = 32 // bits
    r, w = words.shape
    segs = words.view(r, w // granule, 1, granule)
    shifts = (torch.arange(vpw, dtype=torch.int32, device=words.device) * bits)[:, None]
    return ((segs >> shifts) & ((1 << bits) - 1)).reshape(r, -1)[:, :n]


def order_mismatches(remap: torch.Tensor, n_docs: int, b: int, c: int) -> int:
    """Positions at which the program's document order breaks its contract:
    a length of whole superblocks, each document exactly once, the sentinel
    ``n_docs`` only in the tail."""
    n_pad = align_up(n_docs, b * c) if n_docs else 0
    if remap.numel() != n_pad:
        return abs(remap.numel() - n_pad) + n_docs
    head, tail = remap[:n_docs].long(), remap[n_docs:].long()
    ok = (head >= 0) & (head < n_docs)
    seen = torch.zeros(n_docs, dtype=torch.int64, device=remap.device)
    seen.index_add_(0, head[ok], torch.ones_like(head[ok]))
    return int((~ok).sum()) + int((seen != 1).sum()) + int((tail != n_docs).sum())


class RefIndex(NamedTuple):
    vocab: int
    n_docs: int
    b: int
    c: int
    n_blocks: int
    n_sb: int
    remap: torch.Tensor  # int64 [n_pad] position -> doc (the program's order)
    pos_of: torch.Tensor  # int64 [n_docs] doc -> position
    fw_tids: torch.Tensor  # int32 [n_pad, t_pad] (sentinel vocab)
    fw_q: torch.Tensor  # uint8 [n_pad, t_pad]
    blk_scale: torch.Tensor  # float32 [n_blocks]
    rows: torch.Tensor  # int64 [R] the term rows derived, ascending
    blk_lvl: torch.Tensor  # uint8 [R, n_blocks]
    blk_rscale: torch.Tensor  # float32 [R]
    sb_lvl: torch.Tensor  # uint8 [R, n_sb]
    sb_rscale: torch.Tensor  # float32 [R]


def _round_up_levels(w: torch.Tensor, bits: int):
    """Per-row round-up quantization of maximum weights -> (levels, row scales)."""
    levels = (1 << bits) - 1
    row_max = w.amax(dim=1, keepdim=True)
    scales = torch.where(row_max > 0, row_max / levels, 1.0)
    return torch.clamp(torch.ceil(w / scales - 1e-9), 0, levels).to(torch.uint8), scales[:, 0]


def derive(doc_ptr, tids, ws, vocab: int, remap: torch.Tensor, b: int, c: int, bound_bits: int,
           doc_bits: int, rows: torch.Tensor, lane_pad: int = 8, row_chunk: int = 2048) -> RefIndex:
    """The quantized index over ``rows`` (term ids) and every document, in the
    program's document order ``remap``; corpus tensors on the check's device."""
    dev = tids.device
    n_docs = doc_ptr.numel() - 1
    remap = remap.to(dev).long()
    n_pad = remap.numel()
    n_blocks, n_sb = n_pad // b, n_pad // (b * c)
    pos_of = torch.empty(n_docs, dtype=torch.int64, device=dev)
    head = remap[:n_docs]
    pos_of[head] = torch.arange(n_docs, device=dev)
    lens = doc_ptr[1:] - doc_ptr[:-1]
    doc_of = torch.repeat_interleave(torch.arange(n_docs, device=dev), lens)
    post_pos = pos_of[doc_of]
    post_blk = post_pos // b

    # documents: per-block scales, round to nearest, padded rows by position
    levels = (1 << doc_bits) - 1
    blk_max = torch.zeros(n_blocks, dtype=torch.float32, device=dev).scatter_reduce_(0, post_blk, ws, "amax")
    blk_scale = torch.where(blk_max > 0, blk_max / levels, 1.0)
    q = torch.clamp(torch.round(ws / blk_scale[post_blk]), 0, levels).to(torch.uint8)
    t_pad = align_up(max(8, align_up(int(lens.max()), 8)), lane_pad)
    col = torch.arange(tids.numel(), device=dev) - doc_ptr[doc_of]
    fw_tids = torch.full((n_pad, t_pad), vocab, dtype=torch.int32, device=dev)
    fw_q = torch.zeros((n_pad, t_pad), dtype=torch.uint8, device=dev)
    fw_tids[post_pos, col] = tids
    fw_q[post_pos, col] = q
    del q, col

    # bounds of the asked-for term rows, a chunk of rows at a time
    rows = torch.unique(rows.to(dev).long())
    blk_lvl, blk_rscale, sb_lvl, sb_rscale = [], [], [], []
    for lo in range(0, rows.numel(), row_chunk):
        part = rows[lo : lo + row_chunk]
        sel = torch.isin(tids.long(), part)
        r_of = torch.searchsorted(part, tids[sel].long())
        m = torch.zeros((part.numel(), n_blocks), dtype=torch.float32, device=dev)
        m.view(-1).scatter_reduce_(0, r_of * n_blocks + post_blk[sel], ws[sel], "amax")
        lvl, rs = _round_up_levels(m, bound_bits)
        blk_lvl.append(lvl)
        blk_rscale.append(rs)
        lvl, rs = _round_up_levels(m.view(part.numel(), n_sb, c).amax(dim=2), bound_bits)
        sb_lvl.append(lvl)
        sb_rscale.append(rs)
        del m, sel, r_of
    blk_lvl, blk_rscale = torch.cat(blk_lvl), torch.cat(blk_rscale)
    sb_lvl, sb_rscale = torch.cat(sb_lvl), torch.cat(sb_rscale)
    return RefIndex(vocab, n_docs, b, c, n_blocks, n_sb, remap, pos_of, fw_tids, fw_q, blk_scale, rows,
                    blk_lvl, blk_rscale, sb_lvl, sb_rscale)


def index_mismatches(ref: RefIndex, port: dict) -> int:
    """Entries of the program's index (``port``: its leaves, as tensors) that
    differ from the reference's: every document row and block scale, and the
    block and superblock bound rows and row scales of ``ref.rows``."""
    dev = ref.fw_tids.device
    bad = 0
    n_pad = ref.remap.numel()
    tids = port["fwdq_tids"].to(dev).reshape(n_pad, -1)
    qw = port["fwdq_ws"].to(dev).reshape(n_pad, -1)
    if tids.shape != ref.fw_tids.shape or qw.shape != ref.fw_q.shape:
        return n_pad * ref.fw_tids.shape[1]
    bad += int((tids != ref.fw_tids).sum()) + int((qw.to(torch.int32) != ref.fw_q.to(torch.int32)).sum())
    bad += int((port["fwdq_scales"].to(dev) != ref.blk_scale).sum())
    for name, lvl, rscale, n in (("blk", ref.blk_lvl, ref.blk_rscale, ref.n_blocks),
                                 ("sb", ref.sb_lvl, ref.sb_rscale, ref.n_sb)):
        scale = port[f"{name}_scale"]
        if not isinstance(scale, torch.Tensor):
            return bad + lvl.numel()
        words = port[f"{name}_words"][ref.rows.to(port[f"{name}_words"].device)].to(dev)
        got = unpack(words, port[f"{name}_bits"], port[f"{name}_granule"], n)
        bad += int((got != lvl.to(torch.int32)).sum())
        bad += int((scale.to(dev)[ref.rows] != rscale).sum())
    return bad


def canonical(tids: np.ndarray, ws: np.ndarray):
    """A query's terms by weight descending, term id ascending."""
    t = np.asarray(tids, np.int32)
    w = np.asarray(ws, np.float32)
    order = np.lexsort((t, -w))
    return t[order], w[order]


def _pad(queries, vocab: int, device):
    width = max(1, max(len(t) for t, _ in queries))
    tids = np.full((len(queries), width), vocab, np.int32)
    ws = np.zeros((len(queries), width), np.float32)
    for i, (t, w) in enumerate(queries):
        tids[i, : len(t)] = t
        ws[i, : len(w)] = w
    return torch.from_numpy(tids).to(device).long(), torch.from_numpy(ws).to(device)


def _score(ref: RefIndex, qdense: torch.Tensor, q_of: torch.Tensor, pos: torch.Tensor, dtype) -> torch.Tensor:
    """Scores of documents at positions ``pos`` for query rows ``q_of`` (flat
    pairs); padding positions score NEG."""
    out = torch.empty(pos.numel(), dtype=torch.float32, device=pos.device)
    step = max(1, (1 << 24) // ref.fw_tids.shape[1])
    for lo in range(0, pos.numel(), step):
        p, q = pos[lo : lo + step], q_of[lo : lo + step]
        t = ref.fw_tids[p].long()
        qv = qdense[q[:, None], t]
        s = (qv * ref.fw_q[p].to(dtype)).sum(dim=1) * ref.blk_scale[p // ref.b].to(dtype)
        out[lo : lo + step] = s.float()
    return torch.where(ref.remap[pos] < ref.n_docs, out, NEG)


def _canonical_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """(score desc, id asc) top-k along the last axis; slots past the
    candidates or holding NEG come back as (NEG, -1)."""
    if scores.shape[1] < k:
        pad = k - scores.shape[1]
        scores = torch.cat([scores, torch.full((scores.shape[0], pad), NEG, device=scores.device)], 1)
        ids = torch.cat([ids, torch.full((ids.shape[0], pad), -1, dtype=ids.dtype, device=ids.device)], 1)
    by_id = torch.argsort(ids, dim=1, stable=True)
    s1, i1 = scores.gather(1, by_id), ids.gather(1, by_id)
    by_s = torch.argsort(s1, dim=1, descending=True, stable=True)[:, :k]
    vals, out = s1.gather(1, by_s), i1.gather(1, by_s)
    valid = vals > NEG / 2
    return torch.where(valid, vals, NEG), torch.where(valid, out, -1)


def _rows_of(ref: RefIndex, tids: torch.Tensor) -> torch.Tensor:
    r = torch.searchsorted(ref.rows, tids.clamp(max=ref.vocab - 1))
    r = r.clamp(max=ref.rows.numel() - 1)
    if bool(((ref.rows[r] != tids) & (tids < ref.vocab)).any()):
        raise ValueError("a query term's bound row was not derived")
    return r


def search(ref: RefIndex, queries, *, k: int, gamma: int, gamma0: int, beta: float, eta: float,
           dtype=torch.float32, chunk: int = 16):
    """LSP/0 over ``queries`` (a list of (tids, ws)) -> (ids int64 [Q, k],
    scores float32 [Q, k]), -1 / NEG past the results found."""
    dev = ref.fw_tids.device
    ns, c, b = ref.n_sb, ref.c, ref.b
    gamma = min(gamma, ns)
    budget = gamma
    g0 = min(gamma0, gamma, budget)
    out_ids = [torch.empty((0, k), dtype=torch.int64, device=dev)]
    out_scores = [torch.empty((0, k), dtype=torch.float32, device=dev)]
    for lo in range(0, len(queries), chunk):
        part = [canonical(t, w) for t, w in queries[lo : lo + chunk]]
        tids, ws = _pad(part, ref.vocab, dev)
        nq = tids.shape[0]
        qdense = torch.zeros((nq, ref.vocab + 1), dtype=torch.float32, device=dev)
        qdense.scatter_add_(1, tids, ws)
        qdense[:, ref.vocab] = 0.0
        qdense = qdense.to(dtype)
        n_valid = (tids < ref.vocab).sum(dim=1)
        keep_n = torch.ceil(torch.full((nq,), beta, dtype=torch.float32, device=dev) * n_valid).long()
        keep = torch.arange(tids.shape[1], device=dev)[None, :] < keep_n[:, None]
        r = _rows_of(ref, tids)
        w_sb = torch.where(keep, ws * ref.sb_rscale[r], 0.0).to(dtype)
        w_blk = torch.where(keep, ws * ref.blk_rscale[r], 0.0).to(dtype)

        # phase 1: superblock bounds, the SBMax-sorted candidate list
        sbmax = (w_sb[:, :, None] * ref.sb_lvl[r].to(dtype)).sum(dim=1).float()
        top_vals, top_idx = torch.sort(sbmax, dim=1, descending=True, stable=True)
        top_vals, top_idx = top_vals[:, :budget], top_idx[:, :budget]

        # round 0: every document of the first γ0 superblocks; θ = k-th best
        per_sb = c * b
        pos0 = (top_idx[:, :g0, None] * per_sb + torch.arange(per_sb, device=dev)).reshape(nq, -1)
        q0 = torch.arange(nq, device=dev)[:, None].expand_as(pos0)
        s0 = _score(ref, qdense, q0.reshape(-1), pos0.reshape(-1), dtype).view(nq, -1)
        kk = min(k, s0.shape[1])
        theta = torch.clamp(torch.topk(s0, kk, dim=1).values[:, kk - 1], min=0.0)

        # the other superblocks at or above θ, their blocks above θ/η
        rank = torch.arange(budget, device=dev)[None, :]
        eligible = (rank >= g0) & (top_vals >= theta[:, None])
        blk = (top_idx[:, :, None] * c + torch.arange(c, device=dev)).reshape(nq, -1)  # [nq, budget*c]
        bounds = torch.empty(blk.shape, dtype=torch.float32, device=dev)
        for i in range(nq):
            lv = ref.blk_lvl[r[i]][:, blk[i]].to(dtype)  # [L, budget*c]
            bounds[i] = (w_blk[i][:, None] * lv).sum(dim=0).float()
        keep_blk = eligible.repeat_interleave(c, dim=1) & (bounds > (theta / eta)[:, None])
        qi, bi = keep_blk.nonzero(as_tuple=True)
        pos1 = (blk[qi, bi][:, None] * b + torch.arange(b, device=dev)).reshape(-1)
        q1 = qi.repeat_interleave(b)
        s1 = _score(ref, qdense, q1, pos1, dtype)

        # the canonical top-k over both rounds
        n1 = torch.bincount(q1, minlength=nq)
        width = int(n1.max()) if n1.numel() else 0
        slot = torch.arange(q1.numel(), device=dev) - (torch.cumsum(n1, 0) - n1)[q1]
        s1m = torch.full((nq, width), NEG, device=dev)
        p1m = torch.zeros((nq, width), dtype=torch.int64, device=dev)
        s1m[q1, slot] = s1
        p1m[q1, slot] = pos1
        scores = torch.cat([s0, s1m], dim=1)
        ids = ref.remap[torch.cat([pos0, p1m], dim=1)]
        vals, top = _canonical_topk(scores, ids, k)
        out_ids.append(top)
        out_scores.append(vals)
    return torch.cat(out_ids).cpu(), torch.cat(out_scores).cpu()


def score_ids(ref: RefIndex, queries, ids: torch.Tensor) -> torch.Tensor:
    """float32 scores of documents ``ids`` [Q, k] (-1 -> NEG) for their queries."""
    dev = ref.fw_tids.device
    part = [canonical(t, w) for t, w in queries]
    tids, ws = _pad(part, ref.vocab, dev)
    qdense = torch.zeros((len(part), ref.vocab + 1), dtype=torch.float32, device=dev)
    qdense.scatter_add_(1, tids, ws)
    qdense[:, ref.vocab] = 0.0
    ids = ids.to(dev).long()
    ok = (ids >= 0) & (ids < ref.n_docs)
    pos = ref.pos_of[ids.clamp(0, ref.n_docs - 1)]
    q_of = torch.arange(ids.shape[0], device=dev)[:, None].expand_as(ids)
    s = _score(ref, qdense, q_of.reshape(-1), pos.reshape(-1), torch.float32).view(ids.shape)
    return torch.where(ok, s, NEG).cpu()


def exhaustive_topk(ref: RefIndex, doc_ptr, tids, ws, doc_bits: int, queries, k: int,
                    chunk: int = 64) -> torch.Tensor:
    """The rank-safe oracle: ids of the (score desc, id asc) top-k of every
    document, scored from the same quantized documents as a sparse product of
    the corpus (documents by terms) and the queries; -1 past the documents
    that share a term with the query."""
    dev = ref.fw_tids.device
    n_docs = ref.n_docs
    lens = doc_ptr[1:] - doc_ptr[:-1]
    doc_of = torch.repeat_interleave(torch.arange(n_docs, device=dev), lens)
    doc_scale = ref.blk_scale[ref.pos_of // ref.b]
    levels = torch.clamp(torch.round(ws / doc_scale[doc_of]), 0, (1 << doc_bits) - 1)
    del doc_of
    with warnings.catch_warnings():  # torch calls its sparse CSR layout beta
        warnings.simplefilter("ignore", UserWarning)
        docs = torch.sparse_csr_tensor(doc_ptr, tids.long(), levels, size=(n_docs, ref.vocab + 1))
    ids = torch.arange(n_docs, device=dev)
    out = []
    for lo in range(0, len(queries), chunk):
        part = [canonical(t, w) for t, w in queries[lo : lo + chunk]]
        qt, qw = _pad(part, ref.vocab, dev)
        qdense = torch.zeros((len(part), ref.vocab + 1), dtype=torch.float32, device=dev)
        qdense.scatter_add_(1, qt, qw)
        qdense[:, ref.vocab] = 0.0
        s = (docs @ qdense.T).T * doc_scale[None, :]
        s = torch.where(s > 0, s, NEG)
        out.append(_canonical_topk(s, ids.expand(s.shape[0], -1), k)[1])
    return torch.cat(out).cpu()


def recall_shortfall(got_ids: torch.Tensor, oracle_ids: torch.Tensor) -> float:
    """1 - the mean over queries of the share of the oracle's ids (ids [Q, k],
    -1 for none) that the program returned."""
    shares = [len(set(g) & set(o) - {-1}) / max(1, len(set(o) - {-1}))
              for g, o in zip(got_ids.tolist(), oracle_ids.tolist())]
    return 1.0 - float(np.mean(shares)) if shares else 0.0


def compare(got_ids, got_scores, ref_ids, ref_scores, got_rescored) -> dict:
    """The compared numbers of a sample of results (tensors [Q, k] on the host):

    * ``order_violations``: lists not in (score desc, id asc) order on their
      own scores, a result after an empty slot, or an id twice;
    * ``id_score_err``: the largest gap between a reported score and the
      reference's score of the same document, over the query's best
      reference score;
    * ``ids_differ``: the share of ids in one list and not the other, over
      both lists' ids."""
    got_ids, ref_ids = got_ids.long(), ref_ids.long()
    valid = got_ids >= 0
    s, i = got_scores, got_ids
    worse = (s[:, 1:] > s[:, :-1]) | ((s[:, 1:] == s[:, :-1]) & (i[:, 1:] < i[:, :-1]))
    after_empty = valid[:, 1:] & ~valid[:, :-1]
    srt = torch.sort(torch.where(valid, got_ids, -1 - torch.arange(got_ids.shape[1])), dim=1).values
    twice = srt[:, 1:] == srt[:, :-1]
    violations = int(((worse & valid[:, 1:]) | after_empty).sum()) + int(twice.sum())

    top = ref_scores[:, :1].abs().clamp(min=1e-30)
    gap = torch.where(valid, (got_scores - got_rescored).abs() / top, 0.0)
    id_score_err = float(gap.max()) if gap.numel() else 0.0

    n_diff = n_all = 0
    for g, r in zip(got_ids.tolist(), ref_ids.tolist()):
        gs, rs = {x for x in g if x >= 0}, {x for x in r if x >= 0}
        n_diff += len(gs ^ rs)
        n_all += len(gs) + len(rs)
    return {"order_violations": violations, "id_score_err": id_score_err,
            "ids_differ": n_diff / n_all if n_all else 0.0}

"""The yardstick's parts at a tiny size: the work counts of hand-made kernel
calls, the reference against brute force, and the generator's statistics
against the port's ``data/synthetic.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import gen, work
from portbench.reference import lsp


def test_sbmax_work_counts_live_rows_once():
    packed = torch.zeros((10, 4), dtype=torch.int32)  # 4 words of 8 four-bit values: 32 bounds a row
    tids = torch.tensor([[1, 2, 9], [2, 3, 9]], dtype=torch.int32)
    ws = torch.tensor([[0.5, 1.0, 0.0], [2.0, 1.0, 0.0]])
    nbytes, flops = work.sbmax_work(packed, tids, ws, 4, 4)
    # rows 1, 2, 3 read once (16 B each); tids and ws 24 B each; out 2 x 32 floats
    assert nbytes == 3 * 16 + 24 + 24 + 2 * 32 * 4
    assert flops == 2.0 * 4 * 32


def test_boundsum_work_counts_live_granules():
    c, bits = 16, 4  # two words a granule
    packed = torch.zeros((10, 8 * 2), dtype=torch.int32)  # 8 superblocks
    tids = torch.tensor([[1, 2]], dtype=torch.int32)
    ws = torch.tensor([[1.0, 0.0]])
    sel = torch.tensor([[3, 5, 3]], dtype=torch.int32)
    mask = torch.tensor([[True, True, False]])
    nbytes, flops = work.boundsum_work(packed, c, bits, tids, ws, sel, mask)
    # live: term 1 with superblocks 3 and 5 -> 2 granules of 8 B; tids 8 B, ws 8 B, mask 3 B;
    # 2 eligible ids 8 B; out 3 x 16 floats
    assert nbytes == 2 * 8 + 8 + 8 + 3 + 8 + 3 * 16 * 4
    assert flops == 2.0 * 2 * 16


def test_doc_score_work_counts_blocks_and_sectors():
    vocab = 20
    tids3 = torch.full((4, 2, 8), vocab, dtype=torch.int32)  # 4 blocks of 2 docs, 8 slots
    tids3[1, 0, :3] = torch.tensor([0, 1, 9])
    tids3[2, 1, :2] = torch.tensor([17, 18])
    ws3 = torch.ones((4, 2, 8), dtype=torch.uint8)
    blk = torch.tensor([[1, 2, 1], [1, 0, 3]], dtype=torch.int32)
    mask = torch.tensor([[True, True, False], [True, False, False]])
    nbytes, flops = work.doc_score_work(tids3, ws3, vocab + 1, blk, mask)
    # blocks 1, 2 live (2 x 16 slots x 5 B); q0 looks up 0, 1, 9, 17, 18 and q1 0, 1, 9
    # -> sectors 0, 1, 2 of the flat rows (q1 starts at 21: 21, 22 -> 2, 30 -> 3): 4; mask 6 B;
    # 3 live ids 12 B; out 6 x 2 floats
    assert nbytes == 2 * 16 * 5 + 4 * 32 + 6 + 12 + 6 * 2 * 4
    assert flops == 2.0 * (3 + 2 + 3)


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(3.35e12, 0) == 1.0
    assert work.least_seconds(0, 67e12) == 1.0


SPEC = gen.CorpusSpec(n_docs=300, vocab=64, n_topics=4)


def _pack(levels: np.ndarray, bits: int, granule: int) -> torch.Tensor:
    """Lane-strided packing written out value by value."""
    vpw = 32 // bits
    r, n = levels.shape
    seg = granule * vpw
    words = np.zeros((r, -(-n // seg) * granule), np.uint64)
    for i in range(r):
        for v in range(n):
            s, local = divmod(v, seg)
            words[i, s * granule + local % granule] |= np.uint64(int(levels[i, v]) << (bits * (local // granule)))
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def test_unpack_inverts_the_layout():
    rng = np.random.default_rng(0)
    for bits, granule, n in ((4, 2, 37), (4, 128, 1100), (8, 4, 50)):
        lv = rng.integers(0, 1 << bits, size=(3, n))
        got = lsp.unpack(_pack(lv, bits, granule), bits, granule, n)
        assert np.array_equal(got.numpy(), lv)


def _corpus():
    c = gen.make_corpus(SPEC, 5, "cpu")
    return c, np.asarray(torch.randperm(SPEC.n_docs, generator=torch.Generator().manual_seed(1)))


def _remap(order, b, c):
    pad = (-len(order)) % (b * c)
    return torch.from_numpy(np.concatenate([order, np.full(pad, len(order))]).astype(np.int32))


def test_order_mismatches():
    _, order = _corpus()
    good = _remap(order, 4, 8)
    assert lsp.order_mismatches(good, SPEC.n_docs, 4, 8) == 0
    bad = good.clone()
    bad[0] = bad[1]
    assert lsp.order_mismatches(bad, SPEC.n_docs, 4, 8) == 2
    assert lsp.order_mismatches(good[:-1], SPEC.n_docs, 4, 8) > 0


def test_derive_matches_brute_force():
    corpus, order = _corpus()
    b, c = 4, 8
    remap = _remap(order, b, c)
    ref = lsp.derive(corpus.doc_ptr, corpus.tids, corpus.ws, SPEC.vocab, remap, b, c, 4, 8,
                     torch.arange(SPEC.vocab), row_chunk=5)
    ptr, tids, ws = corpus.doc_ptr.numpy(), corpus.tids.numpy(), corpus.ws.numpy()
    nb = len(remap) // b
    blk_max = np.zeros((SPEC.vocab, nb), np.float32)
    for p, d in enumerate(remap.numpy()):
        if d < SPEC.n_docs:
            for j in range(ptr[d], ptr[d + 1]):
                blk_max[tids[j], p // b] = max(blk_max[tids[j], p // b], ws[j])
    for t in range(SPEC.vocab):
        row = blk_max[t]
        scale = np.float32(row.max() / np.float32(15)) if row.max() > 0 else np.float32(1)
        assert ref.blk_rscale[t] == scale
        assert np.array_equal(ref.blk_lvl[t].numpy(), np.clip(np.ceil(row / scale - 1e-9), 0, 15))
        sb = row.reshape(-1, c).max(axis=1)
        assert np.array_equal(ref.sb_lvl[t].numpy(), np.clip(np.ceil(sb / scale - 1e-9), 0, 15))
    for p, d in enumerate(remap.numpy()[:20]):
        n = ptr[d + 1] - ptr[d]
        assert np.array_equal(ref.fw_tids[p, :n].numpy(), tids[ptr[d] : ptr[d + 1]])
        assert (ref.fw_tids[p, n:] == SPEC.vocab).all()


def _naive(ref, query, k, gamma, gamma0, beta):
    """LSP/0 written out a superblock and a block at a time."""
    t, w = lsp.canonical(*query)
    keep = int(np.ceil(np.float32(beta) * np.float32(len(t))))
    row = {int(x): i for i, x in enumerate(ref.rows.tolist())}
    qd = np.zeros(ref.vocab + 1, np.float32)
    qd[t] = w

    def score(p):
        d = int(ref.remap[p])
        if d >= ref.n_docs:
            return None
        s = np.float32(0)
        for tt, qq in zip(ref.fw_tids[p].tolist(), ref.fw_q[p].tolist()):
            s += qd[tt] * np.float32(qq)
        return float(s * ref.blk_scale[p // ref.b]), d

    def bound(lvl, rs, unit):
        return sum(float(w[i] * rs[row[int(t[i])]]) * int(lvl[row[int(t[i])], unit]) for i in range(keep))

    sbs = sorted(range(ref.n_sb), key=lambda s: (-bound(ref.sb_lvl, ref.sb_rscale, s), s))[: min(gamma, ref.n_sb)]
    per_sb = ref.c * ref.b
    found = [score(s * per_sb + j) for s in sbs[:gamma0] for j in range(per_sb)]
    found = [f for f in found if f is not None]
    theta = max(0.0, sorted((f[0] for f in found), reverse=True)[min(k, len(found)) - 1])
    for s in sbs[gamma0:]:
        if bound(ref.sb_lvl, ref.sb_rscale, s) < theta:
            continue
        for blk in range(s * ref.c, (s + 1) * ref.c):
            if bound(ref.blk_lvl, ref.blk_rscale, blk) > theta:
                found += [f for f in (score(blk * ref.b + j) for j in range(ref.b)) if f is not None]
    found.sort(key=lambda f: (-f[0], f[1]))
    return [d for _, d in found[:k]], [s for s, _ in found[:k]]


def test_search_matches_the_naive_traversal():
    corpus, order = _corpus()
    b, c = 4, 4
    remap = _remap(order, b, c)
    ref = lsp.derive(corpus.doc_ptr, corpus.tids, corpus.ws, SPEC.vocab, remap, b, c, 4, 8, torch.arange(SPEC.vocab))
    qs = gen.make_queries(SPEC, corpus, 12, seed=7)
    queries = [qs.get(i) for i in range(len(qs))]
    for k, gamma, gamma0, beta in ((5, 6, 2, 0.5), (30, 10, 3, 0.33)):
        ids, scores = lsp.search(ref, queries, k=k, gamma=gamma, gamma0=gamma0, beta=beta, eta=1.0, chunk=5)
        for i, q in enumerate(queries):
            want_ids, want_scores = _naive(ref, q, k, gamma, gamma0, beta)
            n = len(want_ids)
            assert ids[i, :n].tolist() == want_ids and (ids[i, n:] == -1).all()
            np.testing.assert_allclose(scores[i, :n].numpy(), want_scores, rtol=1e-6)
        rescored = lsp.score_ids(ref, queries, ids)
        nums = lsp.compare(ids, scores, ids, scores, rescored)
        assert nums["order_violations"] == 0 and nums["ids_differ"] == 0 and nums["id_score_err"] < 1e-6


def test_compare_sees_each_fault():
    ids = torch.tensor([[5, 3, 9, -1]])
    scores = torch.tensor([[3.0, 2.0, 2.0, lsp.NEG]])
    ok = lsp.compare(ids, scores, ids, scores, scores)
    assert ok == {"order_violations": 0, "id_score_err": 0.0, "ids_differ": 0.0}
    swapped = lsp.compare(ids[:, [1, 0, 2, 3]], scores[:, [1, 0, 2, 3]], ids, scores, scores[:, [1, 0, 2, 3]])
    assert swapped["order_violations"] == 1
    twice = lsp.compare(torch.tensor([[5, 5, 9, -1]]), scores, ids, scores, scores)
    assert twice["order_violations"] == 1 and twice["ids_differ"] == 1 / 5
    wrong = lsp.compare(ids, scores, ids, scores, scores * torch.tensor([[1.0, 0.5, 1.0, 1.0]]))
    assert wrong["id_score_err"] == pytest.approx(1 / 3)


def test_exhaustive_topk():
    corpus, order = _corpus()
    ref = lsp.derive(corpus.doc_ptr, corpus.tids, corpus.ws, SPEC.vocab, _remap(order, 4, 4), 4, 4, 4, 8,
                     torch.arange(SPEC.vocab))
    qs = gen.make_queries(SPEC, corpus, 3, seed=8)
    queries = [qs.get(i) for i in range(3)]
    got = lsp.exhaustive_topk(ref, corpus.doc_ptr, corpus.tids, corpus.ws, 8, queries, 7, chunk=2)
    everything = lsp.search(ref, queries, k=7, gamma=ref.n_sb, gamma0=ref.n_sb, beta=1.0, eta=1.0)[0]
    assert torch.equal(got, everything)


def test_recall_shortfall():
    oracle = torch.tensor([[4, 2, 7, -1], [1, 3, 5, 6]])
    assert lsp.recall_shortfall(oracle, oracle) == 0.0
    got = torch.tensor([[7, 9, 4, 2], [6, -1, -1, -1]])
    assert lsp.recall_shortfall(got, oracle) == pytest.approx(1 - (3 / 3 + 1 / 4) / 2)


N_DOCS, VOCAB, TOPICS = 20_000, 4096, 16


@pytest.fixture(scope="module")
def both():
    from repro_torch.data.synthetic import CorpusConfig, make_corpus, make_queries

    cfg = CorpusConfig(n_docs=N_DOCS, vocab=VOCAB, n_topics=TOPICS, seed=3)
    np_corpus = make_corpus(cfg)
    np_queries = make_queries(cfg, np_corpus, 2000, seed=4)
    spec = gen.CorpusSpec(n_docs=N_DOCS, vocab=VOCAB, n_topics=TOPICS)
    t_corpus = gen.make_corpus(spec, 3, "cpu")
    t_queries = gen.make_queries(spec, t_corpus, 2000, 3)
    mine = (t_corpus.doc_ptr.numpy(), t_corpus.tids.numpy(), t_corpus.doc_topic.numpy())
    theirs = (np_corpus.doc_ptr, np_corpus.tids, np_corpus.doc_topic)
    return mine, theirs, t_queries, np_queries


def _topical_share(ptr, tids, topic):
    """Share of postings whose term is over three times as frequent in the
    document's topic as in the whole corpus."""
    doc = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    t_of = topic[doc]
    cnt = np.zeros((TOPICS, VOCAB))
    np.add.at(cnt, (t_of, tids), 1)
    expected = cnt.sum(1, keepdims=True) * (cnt.sum(0, keepdims=True) / cnt.sum())
    return float((cnt[t_of, tids] > 3 * expected[t_of, tids]).mean())


def test_document_statistics_match(both):
    (p1, t1, d1), (p2, t2, d2), _, _ = both
    assert np.diff(p1).mean() == pytest.approx(np.diff(p2).mean(), rel=0.02)
    assert np.diff(p1).min() >= 1 and (np.diff(p1) <= np.diff(p2).max() + 15).all()
    head1 = np.sort(np.bincount(t1, minlength=VOCAB))[::-1][:10] / len(t1)
    head2 = np.sort(np.bincount(t2, minlength=VOCAB))[::-1][:10] / len(t2)
    np.testing.assert_allclose(head1, head2, rtol=0.15)
    assert _topical_share(p1, t1, d1) == pytest.approx(_topical_share(p2, t2, d2), rel=0.1)
    for p, t in ((p1, t1), (p2, t2)):  # ascending, distinct term ids within each document
        same_doc = np.repeat(np.arange(len(p) - 1), np.diff(p))
        step = np.diff(t.astype(np.int64))
        assert (step[same_doc[1:] == same_doc[:-1]] > 0).all()


def test_query_statistics_match(both):
    _, _, mine, theirs = both
    l1 = mine.lens
    l2 = np.array([len(t) for t, _ in theirs])
    assert l1.mean() == pytest.approx(l2.mean(), rel=0.05)
    w1 = mine.ws[mine.tids < VOCAB]
    w2 = np.concatenate([w for _, w in theirs])
    assert np.median(w1) == pytest.approx(np.median(w2), rel=0.05)
    t, _ = mine.get(0)
    assert (np.diff(t) > 0).all() and len(t) == l1[0]


def test_same_seed_same_arrays():
    spec = gen.CorpusSpec(n_docs=500, vocab=256, n_topics=4)
    a, b, c = (gen.make_corpus(spec, s, "cpu") for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    assert torch.equal(a.tids, b.tids) and torch.equal(a.ws, b.ws) and torch.equal(a.doc_ptr, b.doc_ptr)
    assert not (a.tids.numel() == c.tids.numel() and torch.equal(a.tids, c.tids))
    qa, qb = gen.make_queries(spec, a, 50, 9), gen.make_queries(spec, b, 50, 9)
    assert np.array_equal(qa.tids, qb.tids) and np.array_equal(qa.ws, qb.ws)

"""Similarity-based block formation, on the index's device.

Same pipeline as the JAX package's ``index/clustering.py``:
  1. random-project the sparse docs to a small dense space (d_proj);
  2. k-means++ seeding, then Lloyd iterations with K ~= n_docs / (b*c);
  3. order docs by (cluster chain rank, distance to centroid) and cut them
     into blocks of b docs; c consecutive blocks form a superblock.

At a million documents and K = 8192 every dense intermediate of the JAX
version ([nnz, d_proj], [n, K] distances and one-hots) is tens of GB, so each
is chunked here; the seeding keeps its D² vector on the device. Float
rounding differs from JAX's, so the clusters can differ (the index build's tests
hold the rest of the build byte-equal given the same doc order).
"""

from __future__ import annotations

import numpy as np
import torch

_POSTING_CHUNK = 1 << 22  # postings per projection step ([chunk, d_proj] floats)
_DOC_CHUNK = 1 << 15  # documents per Lloyd distance step ([chunk, K] floats)


def project_docs(
    doc_ptr: np.ndarray, tids: np.ndarray, ws: np.ndarray, vocab: int, d_proj: int, seed: int,
    device: torch.device,
) -> torch.Tensor:
    """Sparse CSR docs -> L2-normalized dense float32 [n_docs, d_proj] on ``device``."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((vocab, d_proj), dtype=np.float32) / np.sqrt(d_proj)
    proj = torch.from_numpy(proj).to(device, torch.float32)  # numpy's division made it float64
    n_docs = len(doc_ptr) - 1
    doc_of = torch.repeat_interleave(
        torch.arange(n_docs, device=device), torch.from_numpy(np.diff(doc_ptr)).to(device)
    )
    out = torch.zeros((n_docs, d_proj), dtype=torch.float32, device=device)
    for lo in range(0, len(tids), _POSTING_CHUNK):
        hi = min(lo + _POSTING_CHUNK, len(tids))
        t = torch.from_numpy(tids[lo:hi]).to(device, torch.int64)
        w = torch.from_numpy(ws[lo:hi]).to(device)
        out.index_add_(0, doc_of[lo:hi], w[:, None] * proj[t])
    norms = torch.linalg.vector_norm(out, dim=1, keepdim=True)
    return out / torch.clamp(norms, min=1e-9)


def _kmeans_pp_init(x: torch.Tensor, k: int, rng: np.random.Generator) -> torch.Tensor:
    """k-means++ seeding (D² sampling). Each pick is drawn as numpy's
    ``Generator.choice(n, p=d2/sum)`` draws it: one host ``rng.random()``
    searched (side='right') in the float64 CDF, which stays on the device."""
    n = x.shape[0]
    cent = torch.empty((k, x.shape[1]), dtype=torch.float32, device=x.device)
    cent[0] = x[int(rng.integers(n))]
    d2 = ((x - cent[0]) ** 2).sum(dim=1)
    for i in range(1, k):
        p = d2.to(torch.float64)
        total = float(p.sum())
        if total <= 1e-12:  # all points already covered
            cent[i:] = x[torch.from_numpy(rng.integers(n, size=k - i)).to(x.device)]
            break
        cdf = torch.cumsum(p / total, dim=0)
        u = torch.tensor([rng.random()], dtype=torch.float64, device=x.device)
        pick = torch.searchsorted(cdf / cdf[-1], u, right=True)
        cent[i] = x[pick[0]]
        d2 = torch.minimum(d2, ((x - cent[i]) ** 2).sum(dim=1))
    return cent


def _assign(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per document, chunked over documents."""
    c2 = (cent * cent).sum(dim=1)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], _DOC_CHUNK):
        d = -2.0 * (x[lo : lo + _DOC_CHUNK] @ cent.T) + c2[None, :]
        out[lo : lo + _DOC_CHUNK] = torch.argmin(d, dim=1)
    return out


def kmeans(x: torch.Tensor, k: int, iters: int = 8, seed: int = 0):
    """Lloyd iterations from a k-means++ seeding -> (assignments [n], centroids [k, d])."""
    cent = _kmeans_pp_init(x, k, np.random.default_rng(seed))
    assign = None
    for _ in range(iters):
        assign = _assign(x, cent)
        counts = torch.bincount(assign, minlength=k).to(torch.float32)
        sums = torch.zeros_like(cent).index_add_(0, assign, x)
        new_cent = sums / torch.clamp(counts, min=1.0)[:, None]
        cent = torch.where(counts[:, None] > 0, new_cent, cent)  # keep empty clusters
    return assign, cent


def chain_order(cent: torch.Tensor) -> torch.Tensor:
    """Greedy nearest-neighbour chain over centroids -> rank per cluster id, so
    that adjacent clusters in the doc order are similar clusters."""
    k = cent.shape[0]
    left = torch.ones(k, dtype=torch.bool, device=cent.device)
    chain = torch.empty(k, dtype=torch.int64, device=cent.device)
    cur = torch.zeros((), dtype=torch.int64, device=cent.device)
    inf = torch.tensor(float("inf"), device=cent.device)
    for i in range(k):
        chain[i] = cur
        left[cur] = False
        if i + 1 == k:
            break
        d = ((cent - cent[cur]) ** 2).sum(dim=1)
        cur = torch.argmin(torch.where(left, d, inf))
    rank = torch.empty_like(chain)
    rank[chain] = torch.arange(k, device=cent.device)
    return rank


def cluster_order(x: torch.Tensor, k: int, iters: int, seed: int) -> torch.Tensor:
    """k-means of the rows of ``x`` into k clusters, then the row order by
    (cluster's rank in the centroid chain, distance to its centroid): int64 [n]."""
    assign, cent = kmeans(x, k, iters=iters, seed=seed)
    diff = x - cent[assign]
    dist = (diff * diff).sum(dim=1)
    # lexsort((dist, rank)): stable sort by the minor key, then the major
    order = torch.argsort(dist, stable=True)
    return order[torch.argsort(chain_order(cent)[assign][order], stable=True)]


def block_order(
    doc_ptr: np.ndarray,
    tids: np.ndarray,
    ws: np.ndarray,
    vocab: int,
    b: int,
    c: int,
    d_proj: int = 64,
    kmeans_iters: int = 8,
    seed: int = 0,
    *,
    device: torch.device,
) -> torch.Tensor:
    """doc_remap (int32 on ``device``): position -> original doc id,
    similarity-ordered, padded to a multiple of b*c with the sentinel n_docs."""
    n_docs = len(doc_ptr) - 1
    x = project_docs(doc_ptr, tids, ws, vocab, d_proj, seed, device)
    k = max(1, int(np.ceil(n_docs / (b * c))))
    if n_docs <= b:  # degenerate tiny corpus
        order = torch.arange(n_docs, device=device)
    else:
        order = cluster_order(x, k, kmeans_iters, seed)
    pad = (-n_docs) % (b * c)
    fill = torch.full((pad,), n_docs, dtype=order.dtype, device=device)
    return torch.cat([order, fill]).to(torch.int32)

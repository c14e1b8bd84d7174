"""Order-statistics analysis for choosing γ (paper §4.2, Fig. 4, Table 1).

Estimates P_γ(R) — the probability that the γ-th ranked superblock (by SBMax)
contains a top-k document — from a set of training queries:

  1. empirical distribution F of the SBMax *ratio* (SBMax / per-query max SBMax);
  2. per-bin conditional P(R | ratio ∈ B_j) measured against a rank-safe oracle;
  3. CDF of the γ-th maximum order statistic of N iid draws from F, computed with the
     regularized incomplete beta function  P(X_(γ) <= x) = I_{F(x)}(N-γ+1, γ)
     (betainc implemented below via the standard Numerical-Recipes continued
     fraction, vectorized in numpy: the JAX package's arithmetic, so both give
     the same floats).

Host numpy throughout; ``contains_topk`` reads the port's index.
"""

from __future__ import annotations

import numpy as np

from repro_torch.device import to_host


# ----------------------------------------------------------------- special functions
def _betacf(a, b, x, max_iter: int = 200, eps: float = 3e-9):
    """Continued fraction for incomplete beta (NR §6.4), vectorized."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    x = np.asarray(x, np.float64)
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = np.ones_like(x)
    d = 1.0 - qab * x / qap
    d = np.where(np.abs(d) < 1e-30, 1e-30, d)
    d = 1.0 / d
    h = d.copy()
    for m in range(1, max_iter + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = np.where(np.abs(d) < 1e-30, 1e-30, d)
        c = 1.0 + aa / c
        c = np.where(np.abs(c) < 1e-30, 1e-30, c)
        d = 1.0 / d
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = np.where(np.abs(d) < 1e-30, 1e-30, d)
        c = 1.0 + aa / c
        c = np.where(np.abs(c) < 1e-30, 1e-30, c)
        d = 1.0 / d
        delta = d * c
        h = h * delta
        if np.all(np.abs(delta - 1.0) < eps):
            break
    return h


def _gammaln(z):
    """Lanczos log-gamma, vectorized (float64)."""
    g = 7
    coef = np.array(
        [
            0.99999999999980993,
            676.5203681218851,
            -1259.1392167224028,
            771.32342877765313,
            -176.61502916214059,
            12.507343278686905,
            -0.13857109526572012,
            9.9843695780195716e-6,
            1.5056327351493116e-7,
        ]
    )
    z = np.asarray(z, np.float64) - 1.0
    x = np.full_like(z, coef[0])
    for i in range(1, g + 2):
        x = x + coef[i] / (z + i)
    t = z + g + 0.5
    return 0.5 * np.log(2 * np.pi) + (z + 0.5) * np.log(t) - t + np.log(x)


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b), vectorized."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    lbeta = _gammaln(a + b) - _gammaln(a) - _gammaln(b)
    front = np.exp(lbeta + a * np.log(np.maximum(x, 1e-300)) + b * np.log(np.maximum(1 - x, 1e-300)))
    use_direct = x < (a + 1.0) / (a + b + 2.0)
    # direct continued fraction where converging, symmetry transform elsewhere
    direct = front * _betacf(a, b, np.where(use_direct, x, 0.5)) / a
    sym = 1.0 - np.exp(lbeta + b * np.log(np.maximum(1 - x, 1e-300)) + a * np.log(np.maximum(x, 1e-300))) * _betacf(
        b, a, np.where(use_direct, 0.5, 1 - x)
    ) / b
    out = np.where(use_direct, direct, sym)
    out = np.where(x <= 0.0, 0.0, out)
    out = np.where(x >= 1.0, 1.0, out)
    return np.clip(out, 0.0, 1.0)


def order_stat_cdf(gamma: int, n: int, f: np.ndarray) -> np.ndarray:
    """P(X_(γ) <= x) for the γ-th LARGEST of n iid draws, at points with CDF value f.

    X_(γ) <= x  <=>  at least n-γ+1 draws are <= x  <=>  I_F(n-γ+1, γ).
    """
    return betainc(n - gamma + 1, gamma, f)


# ----------------------------------------------------------------- empirical pipeline
def sbmax_ratio_distribution(sbmax: np.ndarray, n_bins: int = 128):
    """sbmax [Q, NS] -> (bin_edges [n_bins+1], F at right edges [n_bins], ratios)."""
    ratios = sbmax / np.maximum(sbmax.max(axis=1, keepdims=True), 1e-9)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    hist, _ = np.histogram(ratios.ravel(), bins=edges)
    cdf = np.cumsum(hist) / max(ratios.size, 1)
    return edges, cdf, ratios


def p_contains_topk_by_bin(
    ratios: np.ndarray, contains: np.ndarray, edges: np.ndarray
) -> np.ndarray:
    """P(R | bin): fraction of (query, superblock) samples in each ratio bin whose
    superblock contains a top-k document. contains: bool [Q, NS]."""
    n_bins = len(edges) - 1
    idx = np.clip(np.digitize(ratios.ravel(), edges) - 1, 0, n_bins - 1)
    tot = np.bincount(idx, minlength=n_bins).astype(np.float64)
    hit = np.bincount(idx, weights=contains.ravel().astype(np.float64), minlength=n_bins)
    return np.where(tot > 0, hit / np.maximum(tot, 1), 0.0)


def p_gamma_contains(gammas: np.ndarray, n_superblocks: int, edges, cdf, p_r_bin) -> np.ndarray:
    """P_γ(R) over an array of γ values (paper Fig. 4 curve)."""
    out = np.zeros(len(gammas))
    f_right = cdf
    f_left = np.concatenate([[0.0], cdf[:-1]])
    for i, g in enumerate(gammas):
        g = min(int(g), n_superblocks)  # γ beyond NS is the NS-th order statistic
        p_right = order_stat_cdf(g, n_superblocks, f_right)
        p_left = order_stat_cdf(g, n_superblocks, f_left)
        p_bin = np.maximum(p_right - p_left, 0.0)
        out[i] = float(np.sum(p_r_bin * p_bin))
    return out


def contains_topk(index, oracle_ids: np.ndarray) -> np.ndarray:
    """bool [Q, NS]: does superblock s contain any oracle top-k doc of query q."""
    remap = to_host(index.doc_remap)
    pos_of = np.full(index.n_docs + 1, -1, np.int64)
    pos_of[remap] = np.arange(len(remap))
    span = index.b * index.c
    q, k = oracle_ids.shape
    out = np.zeros((q, index.n_superblocks), bool)
    for i in range(q):
        ids = oracle_ids[i]
        ids = ids[ids >= 0]
        sbs = pos_of[ids] // span
        out[i, sbs[sbs < index.n_superblocks]] = True
    return out

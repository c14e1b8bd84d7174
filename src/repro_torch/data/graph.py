"""Graph substrate: synthetic graph generation + a real fanout neighbor sampler.

The `minibatch_lg` shape (232,965 nodes / 114.6M edges, batch_nodes=1024,
fanout 15-10) requires GraphSAGE-style layered sampling: the sampler below produces a
static-shape padded subgraph (seeds -> hop1 -> hop2) from a CSR adjacency. A numpy
version (host data pipeline) and shape helpers for the dry-run live here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CSRGraph(NamedTuple):
    indptr: np.ndarray  # int64 [N+1]
    indices: np.ndarray  # int32 [E]
    feats: np.ndarray  # float32 [N, d_feat]
    labels: np.ndarray  # int32 [N]


class SampledSubgraph(NamedTuple):
    """Static-shape 2-hop padded subgraph (valid entries flagged by masks)."""

    node_feats: np.ndarray  # [n_sub, d_feat] gathered features (padded 0)
    node_mask: np.ndarray  # [n_sub] bool
    edge_src: np.ndarray  # [n_edges_sub] int32 (index into subgraph nodes)
    edge_dst: np.ndarray  # [n_edges_sub] int32
    edge_w: np.ndarray  # [n_edges_sub] float32 pseudo-distance for SchNet filters
    edge_mask: np.ndarray  # [n_edges_sub] bool
    seed_ids: np.ndarray  # [batch_nodes] original node ids
    labels: np.ndarray  # [batch_nodes] int32

    @staticmethod
    def shapes(batch_nodes: int, fanout: tuple, d_feat: int) -> dict:
        n1 = batch_nodes * fanout[0]
        n2 = n1 * fanout[1] if len(fanout) > 1 else 0
        n_sub = batch_nodes + n1 + n2
        n_edges = n1 + n2
        return {
            "node_feats": (n_sub, d_feat),
            "node_mask": (n_sub,),
            "edge_src": (n_edges,),
            "edge_dst": (n_edges,),
            "edge_w": (n_edges,),
            "edge_mask": (n_edges,),
            "seed_ids": (batch_nodes,),
            "labels": (batch_nodes,),
        }


def make_random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int = 16, seed: int = 0) -> CSRGraph:
    """Power-law-ish random graph in CSR (degree ~ preferential chunks)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    # mild preferential attachment: square a uniform to skew targets
    dst = (n_nodes * rng.random(n_edges) ** 2).astype(np.int64)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    feats = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return CSRGraph(indptr, dst.astype(np.int32), feats, labels)


def sample_subgraph(
    g: CSRGraph, seeds: np.ndarray, fanout: tuple, rng: np.random.Generator
) -> SampledSubgraph:
    """Layered uniform neighbor sampling with replacement (GraphSAGE), padded to the
    static shapes of SampledSubgraph.shapes."""
    batch = len(seeds)
    d_feat = g.feats.shape[1]
    shp = SampledSubgraph.shapes(batch, fanout, d_feat)

    sub_nodes = [seeds.astype(np.int64)]
    sub_valid = [np.ones(batch, bool)]
    edge_src, edge_dst, edge_mask = [], [], []
    frontier = seeds.astype(np.int64)
    frontier_valid = np.ones(batch, bool)
    offset = 0  # index of frontier within subgraph node list
    next_offset = batch
    for f in fanout:
        deg = g.indptr[frontier + 1] - g.indptr[frontier]
        # sample f neighbors (with replacement) per frontier node
        r = rng.integers(0, np.maximum(deg, 1)[:, None], (len(frontier), f))
        nbr = g.indices[(g.indptr[frontier][:, None] + r).ravel()].astype(np.int64)
        valid = np.repeat(frontier_valid & (deg > 0), f)
        sub_nodes.append(nbr)
        sub_valid.append(valid)
        # message edges: sampled neighbor (src) -> frontier node (dst)
        src_idx = next_offset + np.arange(len(nbr))
        dst_idx = np.repeat(offset + np.arange(len(frontier)), f)
        edge_src.append(src_idx)
        edge_dst.append(dst_idx)
        edge_mask.append(valid)
        offset, next_offset = next_offset, next_offset + len(nbr)
        frontier, frontier_valid = nbr, valid

    nodes = np.concatenate(sub_nodes)
    valid = np.concatenate(sub_valid)
    feats = np.where(valid[:, None], g.feats[nodes % g.feats.shape[0]], 0.0).astype(np.float32)
    es = np.concatenate(edge_src).astype(np.int32)
    ed = np.concatenate(edge_dst).astype(np.int32)
    em = np.concatenate(edge_mask)
    ew = rng.random(len(es)).astype(np.float32) * 5.0  # pseudo-distances in [0, cutoff/2)

    assert feats.shape == shp["node_feats"], (feats.shape, shp["node_feats"])
    return SampledSubgraph(
        node_feats=feats,
        node_mask=valid,
        edge_src=es,
        edge_dst=ed,
        edge_w=ew,
        edge_mask=em,
        seed_ids=seeds.astype(np.int32),
        labels=g.labels[seeds],
    )

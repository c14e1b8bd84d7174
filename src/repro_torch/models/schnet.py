"""SchNet (arXiv:1706.08566): continuous-filter convolution GNN.

The port of the JAX package's ``models/schnet.py``, name for name. Message
passing is a gather over an edge index, a filter, and a segment sum:

  m_ij = (W x_j) * filter(rbf(d_ij));   x_i' = x_i + MLP( segment_sum_j m_ij )

Two input modes share the interaction core: molecules (positions ->
distances, an energy readout) and generic graphs (node features, edge weights
as "distances", node-level outputs).

Indices follow the JAX package's rules, where none raises: a gathered row
wraps once if negative and is then clamped (``common/module.py::take_rows``), and
``segment_sum`` drops ids outside ``[0, num_segments)``. The segment sum is
``index_add_`` in edge order; on CUDA it uses atomics, so the card's sums run
in another order than the CPU's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.common import module as nn
from repro_torch.configs.base import GNNCfg
from repro_torch.device import resolve_device


class InteractionParams(NamedTuple):
    w_node: torch.Tensor  # [H, H] in-projection of neighbor features
    w_filt1: torch.Tensor  # [n_rbf, H] filter-generating network
    w_filt2: torch.Tensor  # [H, H]
    w_out1: torch.Tensor  # [H, H] post-aggregation atom-wise layers
    w_out2: torch.Tensor  # [H, H]


class SchNetParams(NamedTuple):
    embed_in: torch.Tensor  # [d_feat_or_z, H] input projection / atom embedding
    interactions: tuple
    w_read1: torch.Tensor  # [H, H/2]
    w_read2: torch.Tensor  # [H/2, out]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` summed by segment id, in
    order; ids outside ``[0, num_segments)`` add nothing."""
    ids = segment_ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    rows = torch.where(valid.view(-1, *([1] * (data.dim() - 1))), data, torch.zeros((), dtype=data.dtype,
                                                                                     device=data.device))
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add(0, ids.clamp(0, num_segments - 1), rows)


def _ssp(x: torch.Tensor) -> torch.Tensor:
    """shifted softplus, SchNet's activation: ``logaddexp(x, 0) - log 2`` (no
    linear switch above 20, as ``F.softplus`` has)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device)) - math.log(2.0)


def init_schnet(cfg: GNNCfg, in_dim: int, out_dim: int = 1, generator=None, dtype=torch.float32,
                device=None) -> SchNetParams:
    """Parameters on ``device`` (CUDA by default), drawn in a fixed order from
    ``generator``: the interaction blocks, then the input and readout layers."""
    device = resolve_device(device)
    h = cfg.d_hidden
    kw = dict(generator=generator, dtype=dtype, device=device)
    inters = tuple(
        InteractionParams(
            nn.dense_init(h, h, **kw),
            nn.dense_init(cfg.n_rbf, h, **kw),
            nn.dense_init(h, h, **kw),
            nn.dense_init(h, h, **kw),
            nn.dense_init(h, h, **kw),
        )
        for _ in range(cfg.n_interactions)
    )
    return SchNetParams(
        embed_in=nn.dense_init(in_dim, h, **kw),
        interactions=inters,
        w_read1=nn.dense_init(h, max(h // 2, 1), **kw),
        w_read2=nn.dense_init(max(h // 2, 1), out_dim, **kw),
    )


def rbf_centers(cfg: GNNCfg, device=None) -> torch.Tensor:
    """``jnp.linspace(0, cutoff, n_rbf)`` in float32, to the bit. JAX computes
    ``start * (1 - i/div) + stop * (i/div)``; with start 0 and a constant
    stop, XLA's simplifier folds it to ``i * float32(stop / div)``, the last
    one ``stop``. ``torch.linspace`` rounds differently."""
    n, stop = cfg.n_rbf, float(cfg.cutoff)
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    div = n - 1
    delta = torch.tensor(stop, dtype=torch.float32) / torch.tensor(float(div), dtype=torch.float32)
    out = torch.arange(div, dtype=torch.float32) * delta
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32)]).to(device)


def rbf_expand(d: torch.Tensor, cfg: GNNCfg) -> torch.Tensor:
    """Gaussian radial basis on [0, cutoff]: [..., n_rbf]."""
    centers = rbf_centers(cfg, d.device)
    gamma = (cfg.n_rbf / cfg.cutoff) ** 2
    return torch.exp(-gamma * (d[..., None] - centers) ** 2)


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    return torch.where(d < cutoff, 0.5 * (torch.cos(math.pi * d / cutoff) + 1.0), torch.zeros((), dtype=d.dtype,
                                                                                             device=d.device))


def schnet_forward(
    p: SchNetParams,
    cfg: GNNCfg,
    x_in: torch.Tensor,  # [N, in_dim] node features (or one-hot atom types)
    edge_src: torch.Tensor,  # [E] int message source j
    edge_dst: torch.Tensor,  # [E] int message target i
    edge_dist: torch.Tensor,  # [E] float32 distances (or edge weights)
    edge_mask: Optional[torch.Tensor] = None,  # [E] bool (padded edges)
) -> torch.Tensor:
    """Returns node representations [N, H] after n_interactions blocks."""
    n = x_in.shape[0]
    x = x_in @ p.embed_in
    rbf = rbf_expand(edge_dist, cfg)  # [E, n_rbf]
    fcut = cosine_cutoff(edge_dist, cfg.cutoff)
    if edge_mask is not None:
        fcut = fcut * edge_mask.to(fcut.dtype)
    for ip in p.interactions:
        filt = _ssp(rbf @ ip.w_filt1) @ ip.w_filt2  # [E, H]
        msg = nn.take_rows(x @ ip.w_node, edge_src) * filt * fcut[:, None]
        agg = segment_sum(msg, edge_dst, n)
        upd = _ssp(agg @ ip.w_out1) @ ip.w_out2
        x = x + upd
    return x


def schnet_readout(p: SchNetParams, x: torch.Tensor, graph_ids: Optional[torch.Tensor] = None,
                   n_graphs: int = 1) -> torch.Tensor:
    """Atom-wise MLP then sum-pool per graph (energy) — or node-level heads if
    graph_ids is None."""
    h = _ssp(x @ p.w_read1) @ p.w_read2  # [N, out]
    if graph_ids is None:
        return h
    return segment_sum(h, graph_ids, n_graphs)


def molecule_batch_forward(p: SchNetParams, cfg: GNNCfg, z_onehot, positions, edge_src, edge_dst,
                           edge_mask) -> torch.Tensor:
    """Batched small molecules: [B, N, .] arrays, per-graph edges -> energies [B, out].

    The JAX function vmaps a single graph's forward over the batch; here the B
    graphs run as one graph of B·N nodes. Each graph's edge ids are first
    resolved within the graph by the JAX rules (a source wraps and clamps into
    [0, N); a target outside it is dropped), then offset by b·N, so every
    node's and every graph's sum takes the same terms in the same order."""
    bsz, n = z_onehot.shape[:2]
    base = (torch.arange(bsz, device=edge_src.device) * n)[:, None]
    src = nn.jax_rows(edge_src, n) + base
    dst_gather = nn.jax_rows(edge_dst, n) + base
    dst = edge_dst.long()
    dst = torch.where((dst >= 0) & (dst < n), dst + base, torch.full_like(dst, -1))
    pos = positions.reshape(bsz * n, -1)
    diff = pos[src.reshape(-1)] - pos[dst_gather.reshape(-1)] + 1e-9
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    x = schnet_forward(p, cfg, z_onehot.reshape(bsz * n, -1), src.reshape(-1), dst.reshape(-1), d,
                       edge_mask.reshape(-1))
    graph_ids = torch.arange(bsz, device=x.device).repeat_interleave(n)
    return schnet_readout(p, x, graph_ids, bsz)

"""RecSys models: DLRM (dot interaction), DIN (target attention), MIND (multi-interest
capsule routing) on a shared embedding substrate.

The port of the JAX package's ``models/recsys.py``, name for name. All tables
are stacked into ONE ``[total_rows, D]`` matrix with per-field row offsets
(padded to a multiple of 512 rows, as the JAX module pads them for its row
sharding), so a lookup is one gather of ``ids + offsets``.

A gather here reads what ``table[ids]`` reads in JAX, where no index raises:
a negative row wraps once, then every row is clamped into ``[0, R-1]``
(``common/module.py::take_rows``). An id past its own field's vocabulary
reads the next field's rows, in both packages: there is no per-field check.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.common import jax_random
from repro_torch.common import module as nn
from repro_torch.configs.base import RecsysCfg
from repro_torch.device import resolve_device


# ------------------------------------------------------------------ embedding substrate
class EmbedTables(NamedTuple):
    table: torch.Tensor  # [total_rows, D] all fields stacked
    offsets: torch.Tensor  # int32 [n_fields] per-field start row


def init_tables(cfg: RecsysCfg, generator=None, dtype=torch.float32, device=None) -> EmbedTables:
    device = resolve_device(device)
    total = int(sum(cfg.vocab_sizes))
    total = -(-total // 512) * 512  # pad rows so the model axis row-shards evenly
    offsets = torch.tensor(np.cumsum([0] + list(cfg.vocab_sizes[:-1])), dtype=torch.int32, device=device)
    table = nn.embed_init(total, cfg.embed_dim, generator, dtype, device, std=1.0 / np.sqrt(cfg.embed_dim))
    return EmbedTables(table, offsets)


def field_lookup(t: EmbedTables, ids: torch.Tensor) -> torch.Tensor:
    """ids int [B, F] (one id per field) -> [B, F, D]."""
    return nn.take_rows(t.table, ids + t.offsets[None, :])


def bag_lookup(t: EmbedTables, field: int, ids: torch.Tensor, mask: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """EmbeddingBag: ids [B, L] of one field + mask [B, L] -> [B, D] (sum/mean)."""
    rows = nn.take_rows(t.table, ids + t.offsets[field]) * mask[..., None].to(t.table.dtype)
    s = rows.sum(dim=1)
    if reduce == "mean":
        s = s / torch.clamp(mask.sum(dim=1, keepdim=True).to(s.dtype), min=1.0)
    return s


def seq_lookup(t: EmbedTables, ids: torch.Tensor, fields: tuple) -> torch.Tensor:
    """History sequences: ids [B, L, F] -> [B, L, F*D] (concat per-field embeddings)."""
    offs = t.offsets[torch.tensor(fields, dtype=torch.long, device=t.offsets.device)]
    rows = nn.take_rows(t.table, ids + offs[None, None, :])  # [B, L, F, D]
    return rows.reshape(*ids.shape[:2], -1)


def _mlp_params(dims: tuple, generator=None, dtype=torch.float32, device=None) -> tuple:
    return tuple(nn.dense_init(i, o, generator, dtype, device) for i, o in zip(dims[:-1], dims[1:]))


def _mlp(ws, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    for i, w in enumerate(ws):
        x = x @ w
        if i < len(ws) - 1 or final_act:
            x = torch.relu(x)
    return x


# ------------------------------------------------------------------ DLRM
class DLRMParams(NamedTuple):
    tables: EmbedTables
    bot: tuple
    top: tuple


def init_dlrm(cfg: RecsysCfg, generator=None, dtype=torch.float32, device=None) -> DLRMParams:
    """Parameters of ``cfg`` on ``device`` (CUDA by default), drawn in a fixed
    order from ``generator`` (see ``common/module.py``)."""
    device = resolve_device(device)
    n_f = cfg.n_sparse + 1  # embeddings + bottom-MLP output
    n_pairs = n_f * (n_f - 1) // 2
    top_in = cfg.embed_dim + n_pairs
    kw = dict(generator=generator, dtype=dtype, device=device)
    return DLRMParams(
        tables=init_tables(cfg, **kw),
        bot=_mlp_params((cfg.n_dense,) + cfg.bot_mlp, **kw),
        top=_mlp_params((top_in,) + cfg.top_mlp, **kw),
    )


def dlrm_forward(p: DLRMParams, cfg: RecsysCfg, dense: torch.Tensor, sparse_ids: torch.Tensor) -> torch.Tensor:
    """dense [B, 13] f32, sparse_ids [B, 26] int -> logits [B]."""
    bot = _mlp(p.bot, dense, final_act=True)  # [B, D]
    embs = field_lookup(p.tables, sparse_ids)  # [B, F, D]
    z = torch.cat([bot[:, None, :], embs], dim=1)  # [B, F+1, D]
    gram = torch.einsum("bfd,bgd->bfg", z, z)  # [B, F+1, F+1]
    iu, ju = torch.triu_indices(z.shape[1], z.shape[1], 1, device=z.device)  # row-major, as jnp.triu_indices
    pairs = gram[:, iu, ju]  # [B, n_pairs]
    return _mlp(p.top, torch.cat([bot, pairs], dim=1))[:, 0]


# ------------------------------------------------------------------ DIN
class DINParams(NamedTuple):
    tables: EmbedTables
    attn: tuple  # attention MLP over [h, t, h-t, h*t]
    top: tuple


def init_din(cfg: RecsysCfg, generator=None, dtype=torch.float32, device=None) -> DINParams:
    device = resolve_device(device)
    item_dim = cfg.n_sparse * cfg.embed_dim  # concat of per-field embeddings
    top_in = 2 * item_dim  # [weighted history, target]
    kw = dict(generator=generator, dtype=dtype, device=device)
    return DINParams(
        tables=init_tables(cfg, **kw),
        attn=_mlp_params((4 * item_dim,) + cfg.attn_mlp + (1,), **kw),
        top=_mlp_params((top_in,) + cfg.top_mlp, **kw),
    )


def din_forward(p: DINParams, cfg: RecsysCfg, target_ids: torch.Tensor, hist_ids: torch.Tensor,
                hist_mask: torch.Tensor) -> torch.Tensor:
    """target_ids [B, F] int; hist_ids [B, L, F]; hist_mask [B, L] -> logits [B].
    One shot: ``a_in`` is [B, L, 4*I], so a large batch goes through in chunks."""
    fields = tuple(range(cfg.n_sparse))
    t = field_lookup(p.tables, target_ids).reshape(target_ids.shape[0], -1)  # [B, I]
    h = seq_lookup(p.tables, hist_ids, fields)  # [B, L, I]
    tb = t[:, None, :].expand_as(h)
    a_in = torch.cat([h, tb, h - tb, h * tb], dim=-1)
    scores = _mlp(p.attn, a_in)[..., 0]  # [B, L] — DIN: no softmax normalization
    scores = scores * hist_mask.to(scores.dtype)
    interest = torch.einsum("bl,bli->bi", scores, h)  # [B, I]
    return _mlp(p.top, torch.cat([interest, t], dim=-1))[:, 0]


# ------------------------------------------------------------------ MIND
class MINDParams(NamedTuple):
    tables: EmbedTables
    s_bilinear: torch.Tensor  # [I, D_int] capsule transform (shared, B2I routing)
    label_proj: tuple  # label-aware projection MLP (initialised, used by no function)


def init_mind(cfg: RecsysCfg, generator=None, dtype=torch.float32, device=None) -> MINDParams:
    device = resolve_device(device)
    item_dim = cfg.n_sparse * cfg.embed_dim
    kw = dict(generator=generator, dtype=dtype, device=device)
    return MINDParams(
        tables=init_tables(cfg, **kw),
        s_bilinear=nn.dense_init(item_dim, cfg.embed_dim, **kw),
        label_proj=_mlp_params((cfg.embed_dim,) + cfg.top_mlp[:-1] + (cfg.embed_dim,), **kw),
    )


def _squash(z: torch.Tensor, axis: int = -1) -> torch.Tensor:
    n2 = torch.sum(torch.square(z), dim=axis, keepdim=True)
    return (n2 / (1.0 + n2)) * z / torch.sqrt(n2 + 1e-9)


@functools.lru_cache(maxsize=None)
def _routing_init(length: int, k: int) -> torch.Tensor:
    """``jax.random.normal(PRNGKey(0), (1, L, K))``, on the host (see ``common/jax_random.py``)."""
    return torch.from_numpy(jax_random.normal(0, (1, length, k)))


def mind_interests(p: MINDParams, cfg: RecsysCfg, hist_ids: torch.Tensor, hist_mask: torch.Tensor) -> torch.Tensor:
    """Dynamic-routing capsules: hist [B, L, F] -> interests [B, K, D]."""
    fields = tuple(range(cfg.n_sparse))
    h = seq_lookup(p.tables, hist_ids, fields) @ p.s_bilinear  # [B, L, D]
    b_mask = (hist_mask.to(torch.float32) - 1.0) * 1e9  # [B, L]
    # fixed (non-learned, stop-grad) routing-logit init, as in the paper
    blk = _routing_init(h.shape[1], cfg.n_interests).to(h.device)
    b_rout = blk.expand(h.shape[0], h.shape[1], cfg.n_interests)
    interests = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b_rout + b_mask[..., None], dim=-1)  # [B, L, K]
        z = torch.einsum("blk,bld->bkd", w, h)
        interests = _squash(z)
        b_rout = b_rout + torch.einsum("bkd,bld->blk", interests.detach(), h)
    return interests


def mind_user_vector(p, cfg, interests: torch.Tensor, target_emb: torch.Tensor, pow_p: float = 2.0) -> torch.Tensor:
    """Label-aware attention over interests (training-time user vector)."""
    scores = torch.einsum("bkd,bd->bk", interests, target_emb)
    w = torch.softmax(pow_p * scores, dim=-1)
    return torch.einsum("bk,bkd->bd", w, interests)


def mind_score_candidates(interests: torch.Tensor, cand_embs: torch.Tensor) -> torch.Tensor:
    """Serving: max over interests of dot(interest, candidate). [B,K,D]x[N,D]->[B,N]."""
    return torch.einsum("bkd,nd->bkn", interests, cand_embs).amax(dim=1)


def mind_item_embedding(p: MINDParams, cfg: RecsysCfg, item_ids: torch.Tensor) -> torch.Tensor:
    """Candidate/target item embedding in interest space: [.., F] -> [.., D]."""
    flat = field_lookup(p.tables, item_ids.reshape(-1, cfg.n_sparse)).reshape(*item_ids.shape[:-1], -1)
    return flat @ p.s_bilinear


# ------------------------------------------------------------------ losses
def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(logits, -30, 30)
    return torch.mean(torch.clamp(z, min=0) - z * labels + torch.log1p(torch.exp(-torch.abs(z))))


def sampled_softmax_loss(user_vec: torch.Tensor, target_emb: torch.Tensor) -> torch.Tensor:
    """In-batch negatives: [B, D] x [B, D] -> softmax CE over the batch."""
    logits = user_vec @ target_emb.T  # [B, B]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.diagonal(logits)
    return torch.mean(logz - gold)

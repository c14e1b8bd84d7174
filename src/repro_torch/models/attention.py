"""Attention parameters, layer patterns and rotary position embeddings.

The parts the bidirectional encoder needs. The causal flash attention, the
decoder's ``attn_forward`` and its KV cache belong to the decoder-only LM, which
is not ported yet (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.common import module as nn
from repro_torch.configs.base import LMCfg

NEG_INF = -1e30


def layer_kind(cfg: LMCfg, layer: int) -> str:
    """'full' | 'swa' | 'chunked' | 'nope_global' for the given layer index."""
    if cfg.attn_pattern == "full":
        return "full"
    period = cfg.local_ratio + 1
    is_global = (layer + 1) % period == 0
    if cfg.attn_pattern == "hybrid_swa":
        return "full" if is_global else "swa"
    if cfg.attn_pattern == "hybrid_chunked":
        return "nope_global" if is_global else "chunked"
    raise ValueError(cfg.attn_pattern)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd]; positions [B, S] (or [S]) int. Rotates the two halves of
    the head dimension (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [hd/2]
    ang = positions[..., None].float() * freqs  # [B, S, hd/2]
    cos = torch.cos(ang)[..., None, :]  # [B, S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class AttnParams(NamedTuple):
    wq: torch.Tensor  # [D, H*hd]
    wk: torch.Tensor  # [D, KV*hd]
    wv: torch.Tensor  # [D, KV*hd]
    wo: torch.Tensor  # [H*hd, D]
    q_gamma: Optional[torch.Tensor]  # [hd] qk-norm gains
    k_gamma: Optional[torch.Tensor]


def init_attn(cfg: LMCfg, generator=None, dtype=torch.float32, device=None) -> AttnParams:
    hd = cfg.resolved_head_dim()
    kw = dict(generator=generator, dtype=dtype, device=device)
    return AttnParams(
        wq=nn.dense_init(cfg.d_model, cfg.n_heads * hd, **kw),
        wk=nn.dense_init(cfg.d_model, cfg.n_kv_heads * hd, **kw),
        wv=nn.dense_init(cfg.d_model, cfg.n_kv_heads * hd, **kw),
        wo=nn.dense_init(cfg.n_heads * hd, cfg.d_model, **kw),
        q_gamma=nn.ones((hd,), dtype, device) if cfg.qk_norm else None,
        k_gamma=nn.ones((hd,), dtype, device) if cfg.qk_norm else None,
    )

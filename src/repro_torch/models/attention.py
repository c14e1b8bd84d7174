"""Attention: GQA + RoPE + qk-norm + {full | sliding-window | chunked-local} patterns,
with a streaming-softmax ("flash-style") attention for long sequences and a
KV-cache decode path (a ring buffer for local layers).

Layer patterns (driven by LMCfg.attn_pattern / local_ratio):
  full            causal attention, RoPE
  hybrid_swa      gemma3: `local_ratio` sliding-window layers per 1 global layer
  hybrid_chunked  llama4 iRoPE: `local_ratio` chunked-local (RoPE) per 1 global (NoPE)

Each step is computed as the JAX module computes it (its ``lax.scan`` over KV
blocks becomes a loop): score tiles come out of the product in the input dtype
and are then widened to float32 and scaled, the running max, correction, sum
and accumulator follow its order, and each q block's output is cast back to the
input dtype. The loop skips a KV block that the mask hides from every row of
the q tile, which changes no bit (``_block_live``).
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


# ------------------------------------------------------------------ masking
def _block_mask(kind: str, q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """bool [Tq, Tk] allowed-attention mask for absolute positions."""
    m = q_pos[:, None] >= k_pos[None, :]  # causal
    if kind == "swa":
        m &= q_pos[:, None] - k_pos[None, :] < window
    elif kind == "chunked":
        m &= (q_pos[:, None] // window) == (k_pos[None, :] // window)
    return m


def _block_live(kind: str, q0: int, q1: int, k0: int, k1: int, window: int) -> bool:
    """Whether ``_block_mask`` allows any pair of the q positions [q0, q1] and
    the k positions [k0, k1], decided on the host from the bounds.

    A block it rules out changes no bit of the streaming softmax: after a live
    block it adds p = 0 with corr = 1, and before any live block its sums are
    wiped by corr = exp(NEG_INF - m) = 0 at the first live one."""
    if q1 < k0:  # every k after every q
        return False
    if kind == "swa":
        return max(0, q0 - k1) < window  # the closest pair at or below the diagonal
    if kind == "chunked":
        for c in range(max(q0, k0) // window, min(q1, k1) // window + 1):
            # a chunk both ranges reach: its first k at or before its last q
            if min(q1, c * window + window - 1) >= max(k0, c * window):
                return True
        return False
    return True


# ------------------------------------------------------------------ flash attention
def flash_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, KV, hd]
    v: torch.Tensor,
    kind: str,
    window: int,
    q_block: int = 2048,
    k_block: int = 1024,
) -> torch.Tensor:
    """Streaming-softmax attention: O(S) memory, a loop over KV blocks per Q block.

    GQA-native: K/V stay at their g kv heads and the q-head group dim (rep)
    lives in the product, with no repeated copy of K/V."""
    b, s, h, hd = q.shape
    g = k.shape[2]  # kv heads
    rep = h // g
    scale = hd**-0.5
    q_block = min(q_block, s)
    k_block = min(k_block, s)
    nq, nk = s // q_block, s // k_block
    assert s % q_block == 0 and s % k_block == 0

    kg = k.reshape(b, nk, k_block, g, hd)
    vg = v.reshape(b, nk, k_block, g, hd)
    qg = q.reshape(b, nq, q_block, g, rep, hd)
    ar_q = torch.arange(q_block, device=q.device)
    ar_k = torch.arange(k_block, device=q.device)
    outs = []
    for qi in range(nq):
        q_tile = qg[:, qi]  # [B, Tq, g, rep, hd]
        q_pos = qi * q_block + ar_q
        m_run = torch.full((b, g, rep, q_block), NEG_INF, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, g, rep, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, g, rep, q_block, hd), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            if not _block_live(kind, qi * q_block, qi * q_block + q_block - 1, ki * k_block,
                               ki * k_block + k_block - 1, window):
                continue
            k_tile, v_tile = kg[:, ki], vg[:, ki]  # [B, Tk, g, hd]
            mask = _block_mask(kind, q_pos, ki * k_block + ar_k, window)  # [Tq, Tk]
            scores = torch.einsum("bqgrd,bkgd->bgrqk", q_tile, k_tile).float() * scale  # [B, g, rep, Tq, Tk]
            scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m_run, scores.amax(-1))  # [B, g, rep, Tq]
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, v_tile.float())
            m_run = m_new
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]  # [B, g, rep, Tq, hd]
        # cast inside the loop: the per-q-block outputs otherwise live in float32
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # [B, Tq, g, rep, hd]
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


# ------------------------------------------------------------------ full layer fwd
def attn_forward(p: AttnParams, cfg: LMCfg, layer: int, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Training/prefill attention. x [B, S, D] -> [B, S, D]."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    kind = layer_kind(cfg, layer)
    q = (x @ p.wq).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p.wk).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p.wv).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = nn.rms_norm(q, p.q_gamma)
        k = nn.rms_norm(k, p.k_gamma)
    if kind != "nope_global":  # llama4 global layers use NoPE
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    mask_kind = "full" if kind == "nope_global" else kind
    # block sizes: long sequences (prefill) want big q blocks (fewer KV
    # re-streams); short ones want small ones (smaller live score tiles)
    qb_, kb_ = (2048, 1024) if s >= 8192 else (512, 512)
    o = flash_attention(q, k, v, mask_kind, cfg.window, q_block=qb_, k_block=kb_)
    return o.reshape(b, s, cfg.n_heads * hd) @ p.wo


# ------------------------------------------------------------------ decode (KV cache)
class LayerKVCache(NamedTuple):
    """KV cache with merged head dims: [B, L, KV*hd] (L = window for local
    layers, max_len for global ones), as the JAX module lays it out."""

    k: torch.Tensor
    v: torch.Tensor


def cache_len(cfg: LMCfg, layer: int, max_len: int) -> int:
    kind = layer_kind(cfg, layer)
    if kind in ("swa", "chunked") and cfg.window:
        return min(cfg.window, max_len)
    return max_len


def init_layer_cache(cfg: LMCfg, layer: int, batch: int, max_len: int, dtype=torch.bfloat16,
                     device=None) -> LayerKVCache:
    hd = cfg.resolved_head_dim()
    shape = (batch, cache_len(cfg, layer, max_len), cfg.n_kv_heads * hd)
    return LayerKVCache(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))


def attn_decode_step(
    p: AttnParams,
    cfg: LMCfg,
    layer: int,
    x: torch.Tensor,  # [B, 1, D]
    pos: torch.Tensor,  # 0-d int: index of the new token
    cache: LayerKVCache,
) -> tuple[torch.Tensor, LayerKVCache]:
    """One token through the layer's attention. The new K/V row is written
    into ``cache`` in place (the JAX module returns an updated copy), and the
    same cache is returned."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim()
    kind = layer_kind(cfg, layer)
    ln = cache.k.shape[1]
    g, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads

    q = (x @ p.wq).reshape(b, 1, cfg.n_heads, hd)
    k_new = (x @ p.wk).reshape(b, 1, g, hd)
    v_new = (x @ p.wv).reshape(b, 1, g, hd)
    if cfg.qk_norm:
        q = nn.rms_norm(q, p.q_gamma)
        k_new = nn.rms_norm(k_new, p.k_gamma)
    pos_b = pos.expand(b, 1)
    if kind != "nope_global":
        q = apply_rope(q, pos_b, cfg.rope_theta)
        k_new = apply_rope(k_new, pos_b, cfg.rope_theta)

    slot = pos % ln  # ring write for local layers; identity for full-length caches
    cache.k.index_copy_(1, slot.reshape(1).long(), k_new.reshape(b, 1, g * hd).to(cache.k.dtype))
    cache.v.index_copy_(1, slot.reshape(1).long(), v_new.reshape(b, 1, g * hd).to(cache.v.dtype))

    # validity of cache slot j at decode position pos
    j = torch.arange(ln, device=x.device)
    abs_pos = torch.where(j <= slot, pos - slot + j, pos - slot - ln + j)  # ring -> absolute
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if kind == "swa":
        valid &= pos - abs_pos < cfg.window
    elif kind == "chunked":
        valid &= (abs_pos // cfg.window) == (pos // cfg.window)

    # the grouped product equals the JAX module's over K/V repeated rep times
    # (head h reads kv head h // rep), without the repeated copy
    k4 = cache.k.reshape(b, ln, g, hd).to(q.dtype)
    v4 = cache.v.reshape(b, ln, g, hd).to(q.dtype)
    qg = q.reshape(b, 1, g, rep, hd)
    scores = torch.einsum("bqgrd,bjgd->bgrqj", qg, k4).float() * hd**-0.5
    scores = torch.where(valid, scores, NEG_INF).reshape(b, cfg.n_heads, 1, ln)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bgrqj,bjgd->bqgrd", probs.to(q.dtype).reshape(b, g, rep, 1, ln), v4)
    return o.reshape(b, 1, cfg.n_heads * hd) @ p.wo, cache

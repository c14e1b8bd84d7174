"""Decoder-only transformer: parameterized over all 5 assigned LM archs.

Parameters are NamedTuples of tensors; the layers run in a Python loop (the
stacked execution of ``models/stacked.py`` is the production path). The
forward, loss, prefill and decode compute each step as the JAX module does;
the encoder (``models/sparse_encoder.py``) runs the same layers bidirectionally.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common import module as nn
from repro_torch.configs.base import LMCfg
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod


class LayerParams(NamedTuple):
    attn: attn.AttnParams
    ffn: Any  # DenseFFNParams | MoEParams
    norm1: torch.Tensor
    norm2: torch.Tensor


class LMParams(NamedTuple):
    embed: torch.Tensor  # [V_pad, D]
    layers: tuple  # tuple[LayerParams, ...]
    final_norm: torch.Tensor
    lm_head: Optional[torch.Tensor]  # [D, V_pad]; None when tied


def is_moe_layer(cfg: LMCfg, layer: int) -> bool:
    return cfg.moe is not None and (layer % cfg.moe.every_n) == cfg.moe.every_n - 1


def padded_vocab(cfg: LMCfg) -> int:
    """Embedding rows padded up to a multiple of 256 (e.g. granite's 49,155 ->
    49,408). Padded logit columns are masked out of the softmax."""
    return -(-cfg.vocab // 256) * 256


def init_lm(cfg: LMCfg, generator: Optional[torch.Generator] = None, dtype=torch.float32,
            device=None) -> LMParams:
    """Parameters of ``cfg`` on ``device`` (CUDA by default), drawn in a fixed
    order from ``generator`` (see ``common/module.py``)."""
    device = resolve_device(device)
    kw = dict(generator=generator, dtype=dtype, device=device)
    layers = tuple(
        LayerParams(
            attn=attn.init_attn(cfg, **kw),
            ffn=ffn_mod.init_moe(cfg, **kw) if is_moe_layer(cfg, i)
            else ffn_mod.init_dense_ffn(cfg.d_model, cfg.d_ff, **kw),
            norm1=nn.ones((cfg.d_model,), dtype, device),
            norm2=nn.ones((cfg.d_model,), dtype, device),
        )
        for i in range(cfg.n_layers)
    )
    vpad = padded_vocab(cfg)
    return LMParams(
        embed=nn.embed_init(vpad, cfg.d_model, **kw),
        layers=layers,
        final_norm=nn.ones((cfg.d_model,), dtype, device),
        lm_head=None if cfg.tie_embeddings else nn.dense_init(cfg.d_model, vpad, **kw),
    )


def embed_tokens(embed: torch.Tensor, cfg: LMCfg, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows scaled by d_model**0.5 rounded to the embedding's dtype."""
    return F.embedding(tokens.long(), embed) * torch.tensor(cfg.d_model**0.5, dtype=embed.dtype)


def lm_head_logits(params, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the (tied or untied) head: [B, S, D] -> [B, S, V_pad]."""
    x = nn.rms_norm(x, params.final_norm)
    head = params.embed.T if params.lm_head is None else params.lm_head
    return x @ head


def ffn_apply(lp: LayerParams, cfg: LMCfg, layer: int, x: torch.Tensor):
    """The layer's feed-forward (MoE or dense) -> (y, aux loss; 0.0 for a
    dense layer)."""
    if is_moe_layer(cfg, layer):
        return ffn_mod.moe_ffn(lp.ffn, cfg.moe, x)
    return ffn_mod.dense_ffn(lp.ffn, x), 0.0


def _layer_fwd(p: LayerParams, cfg: LMCfg, layer: int, x, positions):
    h = x + attn.attn_forward(p.attn, cfg, layer, nn.rms_norm(x, p.norm1), positions)
    y, aux = ffn_apply(p, cfg, layer, nn.rms_norm(h, p.norm2))
    return h + y, aux


def run_layer(p: LayerParams, cfg: LMCfg, layer: int, x, positions, remat: bool):
    """``_layer_fwd``, under ``torch.utils.checkpoint`` when ``remat`` (the
    backward recomputes the layer instead of keeping its activations)."""
    if remat:
        return checkpoint(lambda p_, x_, pos_: _layer_fwd(p_, cfg, layer, x_, pos_), p, x, positions,
                          use_reentrant=False)
    return _layer_fwd(p, cfg, layer, x, positions)


def positions_of(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)


def lm_forward(params: LMParams, cfg: LMCfg, tokens: torch.Tensor, remat: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V_pad], aux_loss). Train/prefill forward.

    remat=True checkpoints each layer (recompute-in-backward)."""
    x = embed_tokens(params.embed, cfg, tokens)
    positions = positions_of(tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params.layers):
        x, aux = run_layer(lp, cfg, i, x, positions, remat)
        aux_total = aux_total + aux
    return lm_head_logits(params, x), aux_total / max(cfg.n_layers, 1)


def lm_loss(params: LMParams, cfg: LMCfg, tokens: torch.Tensor, labels: torch.Tensor,
            aux_weight: float = 0.01, remat: bool = False):
    """Next-token CE (labels already shifted by the data pipeline). -100 = ignore."""
    logits, aux = lm_forward(params, cfg, tokens, remat=remat)
    ce = _masked_ce(logits, labels, cfg)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor, cfg: LMCfg) -> torch.Tensor:
    """Mean CE over labels >= 0, padded vocab columns masked out. The log-sum-exp
    is reduced in float32 around the (gradient-free) row max; the gold logit is
    a gather, which has the bits of JAX's one-hot masked sum (one logit plus
    exact zeros)."""
    vpad = logits.shape[-1]
    if vpad != cfg.vocab:  # mask padded vocab columns out of the softmax
        col = torch.arange(vpad, device=logits.device)
        logits = torch.where(col < cfg.vocab, logits, logits.new_tensor(-1e9))
    mask = labels >= 0
    labels_safe = torch.where(mask, labels, 0).long()
    m = logits.detach().amax(dim=-1, keepdim=True)
    shifted = (logits - m).float()
    logz = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0].float()
    gold = logits.gather(-1, labels_safe[..., None])[..., 0].float()
    return torch.where(mask, logz - gold, 0.0).sum() / torch.clamp_min(mask.sum(), 1)


# ------------------------------------------------------------------ decode / serve
class DecodeState(NamedTuple):
    caches: tuple  # tuple[attn.LayerKVCache, ...]
    pos: torch.Tensor  # 0-d int32: next position to write


def init_decode_state(cfg: LMCfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> DecodeState:
    device = resolve_device(device)
    caches = tuple(attn.init_layer_cache(cfg, i, batch, max_len, dtype, device) for i in range(cfg.n_layers))
    return DecodeState(caches, torch.zeros((), dtype=torch.int32, device=device))


def decode_layer(lp: LayerParams, cfg: LMCfg, layer: int, x, pos, cache: attn.LayerKVCache):
    """One token through one layer: x [B, 1, D] -> (x, cache written in place)."""
    h, cache = attn.attn_decode_step(lp.attn, cfg, layer, nn.rms_norm(x, lp.norm1), pos, cache)
    x = x + h
    y, _ = ffn_apply(lp, cfg, layer, nn.rms_norm(x, lp.norm2))
    return x + y, cache


def lm_decode_step(params: LMParams, cfg: LMCfg, token: torch.Tensor, state: DecodeState
                   ) -> tuple[torch.Tensor, DecodeState]:
    """token [B, 1] -> (logits [B, 1, V_pad], new state). One serve step. The
    caches of ``state`` are written in place and carried into the new state."""
    x = embed_tokens(params.embed, cfg, token)
    new_caches = []
    for i, lp in enumerate(params.layers):
        x, cache = decode_layer(lp, cfg, i, x, state.pos, state.caches[i])
        new_caches.append(cache)
    return lm_head_logits(params, x), DecodeState(tuple(new_caches), state.pos + 1)


def prefill_cache(lp: LayerParams, cfg: LMCfg, layer: int, x: torch.Tensor, positions: torch.Tensor,
                  out: attn.LayerKVCache) -> None:
    """Write the layer's K/V of the prompt x [B, S, D] into ``out`` (merged
    [B, L, KV*hd] layout): the last L positions when the prompt is at least L
    long, absolute position p at ring slot p % L; else positions 0..S-1 at
    slots 0..S-1, the rest zero."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    normed = nn.rms_norm(x, lp.norm1)
    k = (normed @ lp.attn.wk).reshape(b, s, cfg.n_kv_heads, hd)
    v = normed @ lp.attn.wv
    if cfg.qk_norm:
        k = nn.rms_norm(k, lp.attn.k_gamma)
    if attn.layer_kind(cfg, layer) != "nope_global":
        k = attn.apply_rope(k, positions, cfg.rope_theta)
    k = k.reshape(b, s, cfg.n_kv_heads * hd)
    ln = out.k.shape[1]
    for src, dst in ((k, out.k), (v, out.v)):
        if s >= ln:
            # k_keep[j] holds position s-ln+j -> slot (j + s%ln) % ln: a roll by s % ln
            dst.copy_(torch.roll(src[:, s - ln:], s % ln, dims=1))
        else:
            dst.zero_()
            dst[:, :s] = src


def lm_prefill(params: LMParams, cfg: LMCfg, tokens: torch.Tensor, max_len: int, cache_dtype=torch.bfloat16
               ) -> tuple[torch.Tensor, DecodeState]:
    """Prefill: forward pass + the KV caches for the decode steps that follow.

    The caches are in the merged [B, L, KV*hd] layout that ``lm_decode_step``
    reads. (The JAX module's flat ``lm_prefill`` builds them as [B, L, KV, hd],
    which its own ``lm_decode_step`` cannot read; its stacked prefill merges.)"""
    b, s = tokens.shape
    x = embed_tokens(params.embed, cfg, tokens)
    positions = positions_of(tokens)
    state = init_decode_state(cfg, b, max_len, cache_dtype, x.device)
    for i, lp in enumerate(params.layers):
        prefill_cache(lp, cfg, i, x, positions, state.caches[i])
        x, _ = _layer_fwd(lp, cfg, i, x, positions)
    return lm_head_logits(params, x), DecodeState(state.caches, torch.full_like(state.pos, s))

"""Stacked-layer transformer execution (the serving and training path).

Layers are stacked into GROUPS of ``period`` = local_ratio+1 layers (so every
group sees the same attention-kind pattern and the same MoE/dense interleave:
period is always a multiple of moe.every_n). The JAX module runs one
``lax.scan`` over the groups; here a loop runs over the leading ``[n_groups]``
axis of the stacked leaves, then the tail layers.

Param layout: a tuple over in-group positions of LayerParams whose leaves carry a
leading [n_groups] axis. Layer kind / MoE-ness is position-determined because the
pattern repeats with the group period.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.tree_utils import tree_cast, tree_map
from repro_torch.configs.base import LMCfg
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.transformer import (
    _layer_fwd, _masked_ce, decode_layer, embed_tokens, init_lm, lm_head_logits, positions_of, prefill_cache,
    run_layer,
)


class StackedLMParams(NamedTuple):
    embed: torch.Tensor
    groups: tuple  # tuple over period positions; leaves have leading [n_groups]
    tail: tuple  # trailing n_layers % period layers (unstacked), e.g. gemma3's 62 = 10*6+2
    final_norm: torch.Tensor
    lm_head: Optional[torch.Tensor]


def group_period(cfg: LMCfg) -> int:
    period = (cfg.local_ratio + 1) if cfg.attn_pattern != "full" else 1
    if cfg.moe is not None:
        # period must keep the MoE interleave position-consistent across groups
        period = math.lcm(period, cfg.moe.every_n)
    return period


def _n_groups(cfg: LMCfg) -> int:
    return cfg.n_layers // group_period(cfg)


def init_lm_stacked(cfg: LMCfg, generator: Optional[torch.Generator] = None, dtype=torch.float32,
                    device=None) -> StackedLMParams:
    return stack_params(init_lm(cfg, generator, dtype, device), cfg)


def stack_params(flat_params, cfg: LMCfg) -> StackedLMParams:
    """Convert transformer.LMParams (tuple of layers) to the stacked layout."""
    period = group_period(cfg)
    n_groups = _n_groups(cfg)
    positions = []
    for pos in range(period):
        layers = [flat_params.layers[g * period + pos] for g in range(n_groups)]
        positions.append(tree_map(lambda *xs: torch.stack(xs), *layers))
    return StackedLMParams(
        embed=flat_params.embed,
        groups=tuple(positions),
        tail=tuple(flat_params.layers[n_groups * period:]),
        final_norm=flat_params.final_norm,
        lm_head=flat_params.lm_head,
    )


def _group(params: StackedLMParams, gi: int) -> tuple:
    """The layers of group ``gi``: a tuple over period positions of LayerParams."""
    return tuple(tree_map(lambda x: x[gi], lp) for lp in params.groups)


def _group_fwd(cfg: LMCfg, x, positions, group_params, cast_dtype):
    if cast_dtype is not None:  # only the current group's low-precision copy is live
        group_params = tree_cast(group_params, cast_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pos, lp in enumerate(group_params):
        x, a = _layer_fwd(lp, cfg, pos, x, positions)
        aux = aux + a
    return x, aux


def lm_forward_stacked(
    params: StackedLMParams,
    cfg: LMCfg,
    tokens: torch.Tensor,
    remat: bool = True,
    cast_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V_pad], aux_loss).

    cast_dtype (e.g. bf16): group params are cast inside the loop, so only the
    current group's low-precision copy is live. remat=True checkpoints each
    group. (The JAX module's ``cast_specs`` constrains the cast copies onto a
    mesh sharding, which has no single-device counterpart; it is left out.)"""
    period = group_period(cfg)
    emb = params.embed if cast_dtype is None else params.embed.to(cast_dtype)
    x = embed_tokens(emb, cfg, tokens)
    positions = positions_of(tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    body = partial(_group_fwd, cfg, cast_dtype=cast_dtype)
    for gi in range(_n_groups(cfg)):
        group = _group(params, gi)
        if remat:
            x, aux = checkpoint(body, x, positions, group, use_reentrant=False)
        else:
            x, aux = body(x, positions, group)
        aux_total = aux_total + aux
    n0 = _n_groups(cfg) * period
    for i, lp in enumerate(params.tail):
        if cast_dtype is not None:
            lp = tree_cast(lp, cast_dtype)
        x, a = run_layer(lp, cfg, n0 + i, x, positions, remat)
        aux_total = aux_total + a
    head = params if cast_dtype is None else params._replace(
        embed=emb, lm_head=None if params.lm_head is None else params.lm_head.to(cast_dtype))
    return lm_head_logits(head, x), aux_total / max(cfg.n_layers, 1)


def lm_loss_stacked(params: StackedLMParams, cfg: LMCfg, tokens, labels, aux_weight: float = 0.01,
                    remat: bool = True, cast_dtype=None):
    logits, aux = lm_forward_stacked(params, cfg, tokens, remat=remat, cast_dtype=cast_dtype)
    ce = _masked_ce(logits, labels, cfg)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ------------------------------------------------------------------ decode
class StackedDecodeState(NamedTuple):
    caches: tuple  # per period position: LayerKVCache with leading [n_groups]
    tail_caches: tuple  # per tail layer: plain LayerKVCache
    pos: torch.Tensor  # 0-d int32: next position to write


def init_decode_state_stacked(cfg: LMCfg, batch: int, max_len: int, dtype=torch.bfloat16,
                              device=None) -> StackedDecodeState:
    device = resolve_device(device)
    period = group_period(cfg)
    n_groups = _n_groups(cfg)
    width = cfg.n_kv_heads * cfg.resolved_head_dim()
    caches = []
    for pos in range(period):
        shape = (n_groups, batch, attn.cache_len(cfg, pos, max_len), width)
        caches.append(attn.LayerKVCache(torch.zeros(shape, dtype=dtype, device=device),
                                        torch.zeros(shape, dtype=dtype, device=device)))
    tail = tuple(
        attn.init_layer_cache(cfg, n_groups * period + i, batch, max_len, dtype, device)
        for i in range(cfg.n_layers - n_groups * period)
    )
    return StackedDecodeState(tuple(caches), tail, torch.zeros((), dtype=torch.int32, device=device))


def _group_cache(caches: tuple, gi: int) -> tuple:
    """Views of group ``gi``'s caches: writes to them land in the stacked caches."""
    return tuple(attn.LayerKVCache(c.k[gi], c.v[gi]) for c in caches)


def lm_decode_step_stacked(params: StackedLMParams, cfg: LMCfg, token: torch.Tensor, state: StackedDecodeState
                           ) -> tuple[torch.Tensor, StackedDecodeState]:
    """token [B, 1] -> (logits [B, 1, V_pad], new state). The caches of
    ``state`` are written in place and carried into the new state."""
    period = group_period(cfg)
    x = embed_tokens(params.embed, cfg, token)
    for gi in range(_n_groups(cfg)):
        for pos, (lp, cache) in enumerate(zip(_group(params, gi), _group_cache(state.caches, gi))):
            x, _ = decode_layer(lp, cfg, pos, x, state.pos, cache)
    n0 = _n_groups(cfg) * period
    for i, lp in enumerate(params.tail):
        x, _ = decode_layer(lp, cfg, n0 + i, x, state.pos, state.tail_caches[i])
    return lm_head_logits(params, x), StackedDecodeState(state.caches, state.tail_caches, state.pos + 1)


def lm_prefill_stacked(params: StackedLMParams, cfg: LMCfg, tokens: torch.Tensor, max_len: int,
                       cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, StackedDecodeState]:
    b, s = tokens.shape
    period = group_period(cfg)
    x = embed_tokens(params.embed, cfg, tokens)
    positions = positions_of(tokens)
    state = init_decode_state_stacked(cfg, b, max_len, cache_dtype, x.device)
    for gi in range(_n_groups(cfg)):
        for pos, (lp, cache) in enumerate(zip(_group(params, gi), _group_cache(state.caches, gi))):
            prefill_cache(lp, cfg, pos, x, positions, cache)
            x, _ = _layer_fwd(lp, cfg, pos, x, positions)
    n0 = _n_groups(cfg) * period
    for i, lp in enumerate(params.tail):
        prefill_cache(lp, cfg, n0 + i, x, positions, state.tail_caches[i])
        x, _ = _layer_fwd(lp, cfg, n0 + i, x, positions)
    return lm_head_logits(params, x), state._replace(pos=torch.full_like(state.pos, s))

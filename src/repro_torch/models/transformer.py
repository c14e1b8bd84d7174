"""The transformer's parameters and their initialisation.

The encoder (``models/sparse_encoder.py``) runs these layers bidirectionally.
The decoder-only forward, loss, prefill and decode of the JAX module
(``lm_forward``, ``lm_loss`` and the KV-cache paths) are not ported yet
(ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.common import module as nn
from repro_torch.configs.base import LMCfg
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod


class LayerParams(NamedTuple):
    attn: attn.AttnParams
    ffn: Any  # DenseFFNParams
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
    """Embedding rows padded up to a multiple of 256 (e.g. 30,522 -> 30,720).
    Padded logit columns never reach a caller."""
    return -(-cfg.vocab // 256) * 256


def init_lm(cfg: LMCfg, generator: Optional[torch.Generator] = None, dtype=torch.float32,
            device=None) -> LMParams:
    """Parameters of ``cfg`` on ``device`` (CUDA by default), drawn in a fixed
    order from the CPU ``generator``."""
    ffn_mod.require_dense(cfg)
    device = resolve_device(device)
    kw = dict(generator=generator, dtype=dtype, device=device)
    layers = tuple(
        LayerParams(
            attn=attn.init_attn(cfg, **kw),
            ffn=ffn_mod.init_dense_ffn(cfg.d_model, cfg.d_ff, **kw),
            norm1=nn.ones((cfg.d_model,), dtype, device),
            norm2=nn.ones((cfg.d_model,), dtype, device),
        )
        for _ in range(cfg.n_layers)
    )
    vpad = padded_vocab(cfg)
    return LMParams(
        embed=nn.embed_init(vpad, cfg.d_model, **kw),
        layers=layers,
        final_norm=nn.ones((cfg.d_model,), dtype, device),
        lm_head=None if cfg.tie_embeddings else nn.dense_init(cfg.d_model, vpad, **kw),
    )

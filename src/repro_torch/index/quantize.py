"""Quantization for LSP indexes, on torch tensors.

Same rules and the same float32 arithmetic as the JAX package's
``index/quantize.py`` (numpy), so the two produce the same bytes:
  * document term weights: round-to-nearest-even (BMP convention);
  * block / superblock maximum term weights: round-UP, so
    ``quantize(bound) >= bound`` and threshold pruning stays safe.
"""

from __future__ import annotations

import torch


def _qdtype(bits: int) -> torch.dtype:
    return torch.uint8 if bits <= 8 else torch.uint16


def _global_scale(w: torch.Tensor, levels: int) -> float:
    scale = float(w.max()) / levels if w.numel() else 1.0
    return scale or 1.0


def quantize_weights(w: torch.Tensor, bits: int):
    """Round-to-nearest quantization of document weights -> (q, float scale)."""
    levels = (1 << bits) - 1
    scale = _global_scale(w, levels)
    q = torch.clamp(torch.round(w / scale), 0, levels)
    return q.to(_qdtype(bits)), scale


def quantize_weights_per_block(ws: torch.Tensor, post_blk: torch.Tensor, n_blocks: int, bits: int):
    """Per-block round-to-nearest quantization: block max / levels per block.
    Returns (q, float32 scales [n_blocks]); empty blocks get scale 1.0."""
    levels = (1 << bits) - 1
    blk_max = ws.new_zeros(n_blocks).scatter_reduce_(0, post_blk, ws, "amax")
    scales = torch.where(blk_max > 0, blk_max / levels, 1.0)
    q = torch.clamp(torch.round(ws / scales[post_blk]), 0, levels)
    return q.to(_qdtype(bits)), scales


def quantize_bounds(w: torch.Tensor, bits: int, scale: float | None = None):
    """Round-UP quantization of max-weight bounds with one global scale
    (by default w.max() / levels) -> (q, scale)."""
    levels = (1 << bits) - 1
    if scale is None:
        scale = _global_scale(w, levels)
    q = torch.clamp(torch.ceil(w / scale - 1e-9), 0, levels)
    return q.to(_qdtype(bits)), scale


def quantize_bounds_per_row(w: torch.Tensor, bits: int):
    """Row-scaled round-UP quantization [V, N] -> (q, float32 scales [V]).

    The scales fold into the query weights at search time
    (``core.bounds.fold_scale``), so the bound kernels stay scale-free."""
    levels = (1 << bits) - 1
    row_max = w.amax(dim=1, keepdim=True)
    scales = torch.where(row_max > 0, row_max / levels, 1.0)
    q = torch.clamp(torch.ceil(w / scales - 1e-9), 0, levels)
    return q.to(_qdtype(bits)), scales[:, 0]


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale

"""Bit-packing of block/superblock maximum term weights, on torch tensors.

Same layout as the JAX package's ``index/pack.py`` (which packs with numpy on
the host): fixed 4- or 8-bit values, little-endian within a 32-bit word, in
lane-strided segments. Value v of segment s is stored at word ``s*G + v % G``,
bit-lane ``v // G``, for a granule of G words. The port packs on the index's
device, since the build's dense bound matrices only fit there at full size.
Words are returned as int32 views of the uint32 bits; ``core.bounds.unpack_strided``
is the inverse.
"""

from __future__ import annotations

import torch

from repro_torch.core.bounds import unpack_strided

# Word-tile width of the superblock matrices (one 128-word segment per row tile).
SEG_WORDS = 128


def vals_per_word(bits: int) -> int:
    assert 32 % bits == 0, bits
    return 32 // bits


def align_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= n (and >= multiple)."""
    return max(multiple, -(-n // multiple) * multiple)


def pad_last(a: torch.Tensor, width: int, fill) -> torch.Tensor:
    """Pad the last axis of ``a`` with ``fill`` up to ``width`` (no-op if already)."""
    if a.shape[-1] >= width:
        return a
    return torch.nn.functional.pad(a, (0, width - a.shape[-1]), value=fill)


def _as_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 words < 2^32 -> the uint32 bits as int32."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _udtype(bits: int) -> torch.dtype:
    return torch.uint8 if bits <= 8 else torch.uint16


def pack_rows_strided(q: torch.Tensor, bits: int, granule_words: int) -> torch.Tensor:
    """uint8 [R, N] -> int32 [R, ceil(N / (G*vpw)) * G] lane-strided words."""
    assert q.ndim == 2
    vpw = vals_per_word(bits)
    g = granule_words
    r, n = q.shape
    n_pad = (-n) % (g * vpw)
    if n_pad:
        q = torch.cat([q, q.new_zeros((r, n_pad))], dim=1)
    s = q.shape[1] // (g * vpw)
    q4 = q.to(torch.int64).view(r, s, vpw, g)
    shifts = (torch.arange(vpw, device=q.device, dtype=torch.int64) * bits).view(1, 1, vpw, 1)
    words = (q4 << shifts).sum(dim=2)  # [r, s, g], values < 2^32
    return _as_int32_words(words).view(r, s * g)


def unpack_rows_strided(packed: torch.Tensor, bits: int, granule_words: int, n: int) -> torch.Tensor:
    """Inverse of pack_rows_strided: int32 words [R, W] -> uint8 (uint16
    above 8 bits) [R, n]."""
    return unpack_strided(packed, bits, granule_words)[:, :n].to(_udtype(bits))


def pack_rows(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack uint rows [R, N] -> int32 words [R, ceil(N/vpw)], value j of a
    word at bits [j*bits, (j+1)*bits). Pads N with zeros."""
    assert q.ndim == 2
    vpw = vals_per_word(bits)
    r, n = q.shape
    q = pad_last(q.to(torch.int64), -(-n // vpw) * vpw, 0).view(r, -1, vpw)
    shifts = torch.arange(vpw, device=q.device, dtype=torch.int64) * bits
    return _as_int32_words((q << shifts).sum(dim=2))


def unpack_rows(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of pack_rows -> uint8 (uint16 above 8 bits) [R, n]."""
    vpw = vals_per_word(bits)
    shifts = torch.arange(vpw, device=packed.device, dtype=torch.int64) * bits
    vals = (packed.to(torch.int64)[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(packed.shape[0], -1)[:, :n].to(_udtype(bits))

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

# Word-tile width of the superblock matrices (one 128-word segment per row tile).
SEG_WORDS = 128


def vals_per_word(bits: int) -> int:
    assert 32 % bits == 0, bits
    return 32 // bits


def align_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= n (and >= multiple)."""
    return max(multiple, -(-n // multiple) * multiple)


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
    words = torch.where(words >= 2**31, words - 2**32, words)  # uint32 bits as int32
    return words.to(torch.int32).view(r, s * g)

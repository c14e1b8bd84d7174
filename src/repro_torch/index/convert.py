"""Carry an index built elsewhere into the port.

``from_arrays`` takes any object shaped like an LSPIndex whose array leaves
are numpy arrays (for example the JAX package's index after ``np.asarray`` of
every leaf) and whose other fields are Python ints and floats, and returns the
port's ``LSPIndex`` on ``device``. It reads fields by name, so the source
package never has to be imported. ``from_dense_arrays`` does the same for a
dense-embedding index (``core.lsp_dense.DenseLSPIndex``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lsp_dense import DenseLSPIndex, PackedMinMax
from repro_torch.device import resolve_device
from repro_torch.index.layout import FlatDocsQ, FlatInv, FwdDocs, FwdDocsQ, LSPIndex, PackedBounds


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)  # packed words: same bits, a dtype torch shifts on
    return torch.from_numpy(a).to(device)


def _scale(s, device):
    """A global scale stays a Python float; per-term scales become a tensor."""
    if np.ndim(s) == 0:
        return float(s)
    return _tensor(np.asarray(s, np.float32), device)


def _bounds(pb, device):
    if pb is None:
        return None
    return PackedBounds(
        _tensor(pb.packed, device), int(pb.bits), _scale(pb.scale, device), int(pb.n), int(pb.granule_words)
    )


def from_arrays(src, device=None) -> LSPIndex:
    """The port's LSPIndex holding ``src``'s leaves on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    fwd = src.docs_fwd
    flat = src.docs_flat
    fq = src.docs_fwdq
    flq = src.docs_flatq
    return LSPIndex(
        b=int(src.b),
        c=int(src.c),
        n_docs=int(src.n_docs),
        vocab=int(src.vocab),
        n_blocks=int(src.n_blocks),
        n_superblocks=int(src.n_superblocks),
        sb_bounds=_bounds(src.sb_bounds, device),
        blk_bounds=_bounds(src.blk_bounds, device),
        sb_avg=_bounds(src.sb_avg, device),
        docs_fwd=None if fwd is None else FwdDocs(
            _tensor(fwd.tids, device), _tensor(fwd.ws, device), float(fwd.scale), int(fwd.t_max),
        ),
        docs_flat=None if flat is None else FlatInv(
            _tensor(flat.tids, device), _tensor(flat.local_dids, device), _tensor(flat.ws, device),
            _tensor(flat.block_ptr, device), int(flat.max_block_nnz), float(flat.scale),
        ),
        doc_remap=_tensor(src.doc_remap, device),
        docs_fwdq=None if fq is None else FwdDocsQ(
            _tensor(fq.tids, device), _tensor(fq.ws, device), _tensor(fq.scales, device),
            int(fq.bits), int(fq.t_pad),
        ),
        docs_flatq=None if flq is None else FlatDocsQ(
            _tensor(flq.tids, device), _tensor(flq.ws, device), _tensor(flq.doc_ends, device),
            _tensor(flq.scales, device), int(flq.bits), int(flq.m),
        ),
    )


def _minmax(pm, device):
    return PackedMinMax(
        _tensor(pm.max_packed, device), _tensor(pm.min_packed, device),
        _tensor(np.asarray(pm.scale, np.float32), device), _tensor(np.asarray(pm.zero, np.float32), device),
        int(pm.n), int(pm.granule_words), int(pm.bits),
    )


def from_dense_arrays(src, device=None):
    """The port's DenseLSPIndex holding ``src``'s leaves on ``device`` (CUDA by
    default). ``src.cands`` is a bfloat16 array (numpy's ``ml_dtypes``
    bfloat16); its 16-bit patterns are carried over unchanged."""
    device = resolve_device(device)
    cands = np.asarray(src.cands)
    if cands.dtype.name != "bfloat16":
        raise TypeError(f"cands must be bfloat16, got {cands.dtype}")
    return DenseLSPIndex(
        b=int(src.b),
        c=int(src.c),
        n_cands=int(src.n_cands),
        dim=int(src.dim),
        n_blocks=int(src.n_blocks),
        n_superblocks=int(src.n_superblocks),
        sb=_minmax(src.sb, device),
        blk=_minmax(src.blk, device),
        cands=_tensor(cands.view(np.uint16), device).view(torch.bfloat16),
        remap=_tensor(src.remap, device),
    )

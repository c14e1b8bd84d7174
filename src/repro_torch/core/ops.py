"""Dispatch layer between the traversal and the kernels.

Each op has one wrapper (``kernels/*/ops.py``: scales, id clamps) and two raw
functions it can run, the CUDA kernel and its plain PyTorch version. The raw
function is chosen here, once per call, from ``impl`` and the operand's device:
  "auto"    the CUDA kernel for CUDA tensors, the plain version for CPU tensors
  "ref"     the plain version, on any device
  "kernel"  the CUDA kernel; raises for CPU tensors
There is no fallback: a kernel that fails to build or launch raises.

A caller may take the raw launches over (``launches_through``): CUDA graphs
of the traversal (``core.graphs``) capture the op chains between them and
run each launch itself, by the name of the ``core.ops`` attribute it would
have called.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable

import torch

from repro_torch.core.config import ConfigError
from repro_torch.index.layout import PackedBounds
from repro_torch.kernels.boundsum_gather.kernel import boundsum_gather_kernel
from repro_torch.kernels.boundsum_gather.ops import boundsum_gather_op
from repro_torch.kernels.boundsum_gather.ref import boundsum_gather_ref
from repro_torch.kernels.dequant_matmul.kernel import dequant_matmul_kernel
from repro_torch.kernels.dequant_matmul.ops import dequant_matmul_op
from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref
from repro_torch.kernels.doc_score.kernel import doc_score_flat_kernel, doc_score_fwd_kernel
from repro_torch.kernels.doc_score.ops import doc_score_flat_op, doc_score_fwd_op
from repro_torch.kernels.doc_score.ref import doc_score_flat_ref, doc_score_fwd_ref
from repro_torch.kernels.sbmax.kernel import sbmax_kernel
from repro_torch.kernels.sbmax.ops import sbmax_op
from repro_torch.kernels.sbmax.ref import sbmax_ref

IMPLS = ("auto", "ref", "kernel")

_hook = threading.local()


@contextlib.contextmanager
def launches_through(hook: Callable):
    """Inside the block, every raw launch this thread makes calls
    ``hook(name, *args)`` in its place, where ``name`` is the attribute of
    this module that would have run (``sbmax_kernel``, ``sbmax_ref``, ...)."""
    prev = getattr(_hook, "fn", None)
    _hook.fn = hook
    try:
        yield
    finally:
        _hook.fn = prev


def _raw(impl: str, t: torch.Tensor, kernel: str, plain: str) -> Callable:
    """The raw function ``impl`` picks for operand ``t``, by its attribute
    name here (looked up at each call, so a wrapper set on the attribute
    sees every launch)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref":
        name = plain
    elif t.is_cuda:
        name = kernel
    elif impl == "kernel":
        raise ValueError("impl='kernel' runs the CUDA kernels and needs CUDA tensors; "
                         "use impl='auto' or 'ref' on the CPU")
    else:
        name = plain
    hook = getattr(_hook, "fn", None)
    return globals()[name] if hook is None else functools.partial(hook, name)


def sbmax(pb: PackedBounds, tids: torch.Tensor, ws: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """BoundSum / SBMax (paper Eq. 1): [Q, pb.n] = sum_i ws[:, i] * W[tids[:, i], :]."""
    return sbmax_op(pb, tids, ws, _raw(impl, pb.packed, "sbmax_kernel", "sbmax_ref"))


def gathered_block_bounds(pb: PackedBounds, c: int, tids: torch.Tensor, ws: torch.Tensor,
                          sel_sb: torch.Tensor, sel_mask: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Block BoundSum restricted to the selected superblocks' blocks: [Q, S, c],
    0 where ``sel_mask`` [Q, S] is False (the kernel reads no masked granule)."""
    raw = _raw(impl, pb.packed, "boundsum_gather_kernel", "boundsum_gather_ref")
    return boundsum_gather_op(pb, c, tids, ws, sel_sb, sel_mask, raw)


def scoring_operand(index, layout: str):
    """The quantized operand documents are scored from under ``layout``
    (``docs_fwdq`` or ``docs_flatq``); raises ``ConfigError`` if the index
    was built without it (``IndexBuildConfig(build_flat_inv=False)``)."""
    operand = index.docs_flatq if layout == "flat" else index.docs_fwdq
    if operand is None:
        raise ConfigError(f"doc_layout={layout!r} needs the index's quantized '{layout}' scoring operand, "
                          "which this index was built without")
    return operand


def score_gather(index, qdense: torch.Tensor, blk_ids: torch.Tensor, blk_mask: torch.Tensor,
                 layout: str = "fwd", impl: str = "auto") -> torch.Tensor:
    """Per-document scores of the selected blocks: [Q, S] block ids and their
    bool mask -> [Q, S, b], with the per-block dequant scales applied, from
    the ``layout`` operand ("fwd" or "flat"). Masked blocks score 0 (the
    kernels do not read them); padded documents are not masked here
    (``scoring.score_blocks`` masks both to NEG)."""
    operand = scoring_operand(index, layout)
    if layout == "flat":
        raw = _raw(impl, operand.tids, "doc_score_flat_kernel", "doc_score_flat_ref")
        return doc_score_flat_op(operand, qdense, blk_ids, blk_mask, raw)
    raw = _raw(impl, operand.tids, "doc_score_fwd_kernel", "doc_score_fwd_ref")
    return doc_score_fwd_op(operand, qdense, blk_ids, blk_mask, raw)


def dequant_matmul(x: torch.Tensor, packed_w: torch.Tensor, bits: int, n: int, scale: float = 1.0,
                   impl: str = "auto") -> torch.Tensor:
    """Dense-embedding bound GEMM: float32 [M, n] = (x @ dequant(packed_w))[:, :n] * scale."""
    raw = _raw(impl, packed_w, "dequant_matmul_kernel", "dequant_matmul_ref")
    return dequant_matmul_op(x, packed_w, bits, n, scale, raw)

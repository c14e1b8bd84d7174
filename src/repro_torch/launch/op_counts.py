"""What a step computes and moves, counted op by op as PyTorch dispatches it.

The counterpart of the JAX package's ``launch/hlo_flops.py`` and
``launch/hlo_analysis.py``, which parse XLA's compiled HLO. Eager PyTorch
compiles nothing, so ``OpCounter``, a ``TorchDispatchMode``, counts each aten
op the step dispatches, forward and backward (a recomputed checkpoint
segment dispatches again, and is counted again). It runs on ``meta``
tensors, so a full-size step is counted without allocating it:

  flops        the formulas of ``torch.utils.flop_counter`` (products,
               convolutions, attention), as ``hlo_flops`` counts dots and
               convolutions
  bytes        every op's tensor inputs plus its outputs, leaving out views
               (``hlo_flops``' ``bytes`` without ``_SKIP_BYTES``)
  bytes_major  the same bytes for the op kinds of ``hlo_flops._MAJOR``:
               products, gathers and index ops, scatters and ``index_add``,
               reductions, sorts and top-k, and copies into a slice of a
               buffer (XLA's dynamic-update-slice)
  ops          op counts by name (``fusion_stats``: in eager PyTorch each
               op is a launch)

No trip count needs parsing: an eager loop dispatches every trip. What GSPMD
would insert on a mesh (all-gathers, reduce-scatters) has no eager
counterpart, so no collective is counted.
"""

from __future__ import annotations

import functools
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# ops that alias their input without moving data (besides ``OpOverload.is_view``)
_ALIASES = {"_unsafe_view", "lift_fresh", "alias", "detach", "_reshape_alias"}
_MAJOR = {
    # products
    "mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot", "convolution", "convolution_backward",
    # gathers and index ops
    "index", "gather", "index_select", "embedding", "take", "take_along_dim",
    # scatters and index_add
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_", "index_add",
    "index_add_", "index_put", "index_put_", "_index_put_impl_", "index_copy", "index_copy_",
    "embedding_dense_backward",
    # reductions
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp", "norm", "linalg_vector_norm", "var",
    "std", "var_mean", "any", "all", "argmax", "argmin", "cumsum", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data",
    # sorts and top-k
    "sort", "topk", "argsort", "kthvalue",
    # slices into a buffer
    "slice_scatter", "select_scatter", "as_strided_scatter",
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class _Unkeyed(Exception):
    pass


def _key(x, out: list) -> None:
    """Append a hashable key of ``x`` to ``out``: a tensor's metadata, any
    other leaf's value. Raises _Unkeyed for a tensor off ``meta`` or an
    unhashable leaf."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _Unkeyed
        out.append((x.shape, x.stride(), x.dtype, x.storage_offset()))
    elif isinstance(x, (list, tuple)):
        out.append(len(x))
        for v in x:
            _key(v, out)
    elif isinstance(x, dict):
        for k, v in x.items():
            out.append(k)
            _key(v, out)
    else:
        try:
            hash(x)
        except TypeError:
            raise _Unkeyed from None
        out.append((type(x), x))


def _signature(func, args, kwargs):
    """The memo key of a call, or None if it has none."""
    out = [func]
    try:
        _key(args, out)
        _key(kwargs, out)
    except _Unkeyed:
        return None
    return tuple(out)


@functools.cache
def _fresh(func) -> bool:
    """True if the op returns new tensors only: no view, no alias, no write."""
    schema = func._schema
    return not func.is_view and not schema.is_mutable and all(r.alias_info is None for r in schema.returns)


def _out_spec(out):
    """The outputs' metadata; raises _Unkeyed for an output off ``meta`` (a
    factory op of another device: its key has no tensor to tell)."""
    if isinstance(out, torch.Tensor):
        if not out.is_meta:
            raise _Unkeyed
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return type(out)(_out_spec(v) for v in out)
    return out


def _out_from(spec):
    if isinstance(spec, tuple) and len(spec) == 3 and isinstance(spec[2], torch.dtype):
        return torch.empty_strided(spec[0], spec[1], dtype=spec[2], device="meta")
    if isinstance(spec, (list, tuple)):
        return type(spec)(_out_from(v) for v in spec)
    return spec


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: step(*args)``, then ``c.flops``, ``c.bytes``,
    ``c.bytes_major`` and ``c.ops``.

    On meta tensors an op's outputs and counts depend only on its inputs'
    metadata, so an op that returns fresh tensors is run once per distinct
    signature and answered from that afterwards (the repeated layers, tiles
    and micro-batches of a step); every dispatch is still counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.bytes_major = 0
        self.ops: Counter = Counter()
        self.n_views = 0
        self._memo: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if func.is_view or name in _ALIASES:
            self.n_views += 1
            return func(*args, **kwargs)
        self.ops[name] += 1
        key = _signature(func, args, kwargs) if _fresh(func) else None
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            spec, flops, nbytes, major = hit
            out = _out_from(spec)
        else:
            out = func(*args, **kwargs)
            flops, nbytes, major = self._count(func, name, args, kwargs, out)
            if key is not None:
                try:
                    self._memo[key] = (_out_spec(out), flops, nbytes, major)
                except _Unkeyed:
                    pass
        self.flops += flops
        self.bytes += nbytes
        self.bytes_major += major
        return out

    @staticmethod
    def _count(func, name, args, kwargs, out) -> tuple:
        packet = func.overloadpacket
        flops = int(flop_registry[packet](*args, **kwargs, out_val=out)) if packet in flop_registry else 0
        nbytes = _nbytes((args, kwargs)) + _nbytes(out)
        # a copy into a view writes a slice of a buffer (a KV cache, a stacked leaf)
        major = name in _MAJOR or (name == "copy_" and args[0]._base is not None)
        return flops, nbytes, nbytes if major else 0

    def op_stats(self) -> dict:
        return {"n_ops": sum(self.ops.values()), "n_view_ops": self.n_views,
                "ops": dict(self.ops.most_common())}

    def record(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes, "bytes_major": self.bytes_major}

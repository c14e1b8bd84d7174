"""Per-architecture sharding rules (partition specs) for params and inputs, and
the placements that carry them out over a process group.

The port of the JAX package's ``distributed/sharding.py``. Conventions (axes
pod/data/model):
  * LM: Megatron TP over `model` (attention heads + FFN hidden), DP over pod+data,
    vocab/embedding sharded over `model`, MoE experts over `model` (EP);
  * KV caches: heads over `model`; for single-sequence long-context decode the cache
    LENGTH shards over `data` (sequence parallelism) since batch can't;
  * recsys: one stacked embedding table row-sharded over `model` (EP analogue),
    dense MLPs replicated, batch over pod+data;
  * GNN: edge-parallel — edge arrays sharded over every axis, node arrays replicated,
    segment-sums psum-reduced;
  * retrieval: index unit dims (superblocks/blocks/docs) sharded over `model`,
    queries over pod+data.

The rules read only a mesh's ``axis_names`` and ``shape``, so they take a
``launch.mesh.MeshShape`` as well as a ``DeviceMesh``, and they walk the
port's own parameter trees, which have the JAX package's classes and fields.

``PartitionSpec`` is the port's copy of JAX's: one entry per leading
dimension, each None (replicated), an axis name, or a tuple of names (the
dimension split over those axes, the first the major one: ``("data", "pod")``
puts data coordinate d, pod coordinate p at block ``d * n_pod + p``).

``NamedSharding(mesh, spec)`` is the placement that JAX's ``NamedSharding``
and ``device_put`` make. ``indices``/``devices_indices_map`` give each
coordinate's slices of a global shape as JAX's ``devices_indices_map`` does
(a dimension its axes do not divide raises ValueError, as JAX's
``device_put`` does); ``shard`` (``device_put``) keeps this rank's shard of
a whole tensor; ``gather`` assembles a leaf's shards into the whole;
``reshard`` moves a rank's shard onto another placement over the same ranks,
sending each piece once from one of the ranks that hold it.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.common.tree_utils import tree_map
from repro_torch.distributed.topk import to_wire, wire_device
from repro_torch.index.layout import FlatDocsQ, FlatInv, FwdDocs, FwdDocsQ, LSPIndex, PackedBounds
from repro_torch.models.attention import AttnParams, LayerKVCache
from repro_torch.models.ffn import DenseFFNParams, MoEParams
from repro_torch.models.recsys import EmbedTables
from repro_torch.models.stacked import StackedDecodeState, StackedLMParams
from repro_torch.models.transformer import DecodeState, LayerParams, LMParams
from repro_torch.optim.adafactor import FactoredMoment


class PartitionSpec:
    """A partition spec: one entry per leading dimension (None, an axis name,
    or a tuple of axis names); dimensions past the last entry are replicated.
    A leaf of the port's trees (not a tuple), as JAX's is of its pytrees."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(tuple(p) if isinstance(p, list) else p for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self._parts == other._parts

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._parts!r}"


P = PartitionSpec


def _batch(mesh) -> Any:
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


# ------------------------------------------------------------------ LM
def lm_param_specs(params: LMParams, mesh, fsdp: bool = True, kv_shard: bool = True) -> LMParams:
    """Megatron TP over `model` + (optionally) FSDP over `data` on the other matmul
    dim; `pod` stays pure DP (params replicated across pods, gradients reduced over
    the pod links).

    kv_shard=False replicates the K/V projections' head dim: with GQA (8 KV heads)
    on a 16-way model axis, sharding KV heads pads 2x and forces halo exchanges in
    attention — for train/prefill the KV tensors are small, so Q-heads shard and KV
    replicates (decode keeps kv_shard=True: there the KV *cache* dominates memory).

    With a pod axis, FSDP spans (data, pod)."""
    f = (("data", "pod") if "pod" in mesh.axis_names else "data") if fsdp else None
    kv = "model" if kv_shard else None

    def attn_spec(p: AttnParams) -> AttnParams:
        return AttnParams(
            wq=P(f, "model"),
            wk=P(f, kv),
            wv=P(f, kv),
            wo=P("model", f),
            q_gamma=None if p.q_gamma is None else P(None),
            k_gamma=None if p.k_gamma is None else P(None),
        )

    def ffn_spec(p):
        if isinstance(p, MoEParams):
            return MoEParams(
                router=P(None, None),
                w_gate=P("model", f, None),  # EP over model + FSDP over d_model
                w_up=P("model", f, None),
                w_down=P("model", None, f),
                shared=None if p.shared is None else DenseFFNParams(
                    P(f, "model"), P(f, "model"), P("model", f)
                ),
            )
        return DenseFFNParams(P(f, "model"), P(f, "model"), P("model", f))

    layers = tuple(
        LayerParams(attn=attn_spec(lp.attn), ffn=ffn_spec(lp.ffn), norm1=P(None), norm2=P(None))
        for lp in params.layers
    )
    return LMParams(
        embed=P("model", None),
        layers=layers,
        final_norm=P(None),
        lm_head=None if params.lm_head is None else P(None, "model"),
    )


def stacked_lm_param_specs(stacked_params: StackedLMParams, mesh, fsdp: bool = True, kv_shard: bool = True):
    """Specs for models.stacked.StackedLMParams: per-position layer specs with a
    leading None (the n_groups axis); embed/head as in lm_param_specs.
    FSDP spans (data, pod) on multi-pod meshes (see lm_param_specs)."""
    f = (("data", "pod") if "pod" in mesh.axis_names else "data") if fsdp else None
    kv = "model" if kv_shard else None

    def layer_spec(lp: LayerParams, prepend) -> LayerParams:
        a = lp.attn
        attn_s = AttnParams(
            wq=prepend(P(f, "model")),
            wk=prepend(P(f, kv)),
            wv=prepend(P(f, kv)),
            wo=prepend(P("model", f)),
            q_gamma=None if a.q_gamma is None else prepend(P(None)),
            k_gamma=None if a.k_gamma is None else prepend(P(None)),
        )
        if isinstance(lp.ffn, MoEParams):
            # EP over model x TP over the expert hidden dim (not FSDP over d_model):
            # the expert weights stay resident-sharded
            ffn_s = MoEParams(
                router=prepend(P(None, None)),
                w_gate=prepend(P("model", None, f)),
                w_up=prepend(P("model", None, f)),
                w_down=prepend(P("model", f, None)),
                shared=None if lp.ffn.shared is None else DenseFFNParams(
                    prepend(P(f, "model")), prepend(P(f, "model")), prepend(P("model", f))
                ),
            )
        else:
            ffn_s = DenseFFNParams(
                prepend(P(f, "model")), prepend(P(f, "model")), prepend(P("model", f))
            )
        return LayerParams(attn=attn_s, ffn=ffn_s, norm1=prepend(P(None)), norm2=prepend(P(None)))

    stk = lambda spec: None if spec is None else P(*((None,) + tuple(spec)))
    flat = lambda spec: spec
    return StackedLMParams(
        embed=P("model", None),
        groups=tuple(layer_spec(g, stk) for g in stacked_params.groups),
        tail=tuple(layer_spec(t, flat) for t in stacked_params.tail),
        final_norm=P(None),
        lm_head=None if stacked_params.lm_head is None else P(None, "model"),
    )


def adafactor_state_specs(param_specs):
    """Factored-moment specs derived from param specs: vr drops the last axis,
    vc drops the second-to-last (matching optim/adafactor.py's shapes)."""

    def mk(spec):
        parts = tuple(spec)
        if len(parts) >= 2:
            return FactoredMoment(P(*parts[:-1]), P(*(parts[:-2] + parts[-1:])))
        return FactoredMoment(spec, P())

    return tree_map(mk, param_specs)  # an absent param (None) keeps an absent moment


def lm_batch_specs(mesh, seq_sharded: bool = False):
    """tokens/labels [B, S]."""
    b = _batch(mesh)
    return P(b, None) if not seq_sharded else P(b, "model")


def kv_cache_spec(mesh, batch: int, kv_heads: int, stacked: bool = False):
    """Merged-layout cache [B, L, KV*hd] (+leading n_groups when stacked).

    The merged head dim always divides `model` (KV*hd >= 1024), matching the natural
    wk/wv column sharding. When the batch is too small to shard (batch 1) the cache
    LENGTH shards over pod+data instead — sequence parallelism.
    """
    b = _batch(mesh)
    bsz = mesh.shape["data"] * (mesh.shape["pod"] if "pod" in mesh.axis_names else 1)
    spec = P(b, None, "model") if batch >= bsz else P(None, b, "model")
    if stacked:
        spec = P(*((None,) + tuple(spec)))
    return spec


def decode_state_specs(state, mesh, batch: int, kv_heads: int, stacked: bool = False):
    spec = kv_cache_spec(mesh, batch, kv_heads, stacked=stacked)
    caches = tuple(LayerKVCache(spec, spec) for _ in state.caches)
    if stacked:
        flat_spec = kv_cache_spec(mesh, batch, kv_heads, stacked=False)
        tail = tuple(LayerKVCache(flat_spec, flat_spec) for _ in state.tail_caches)
        return StackedDecodeState(caches=caches, tail_caches=tail, pos=P())
    return DecodeState(caches=caches, pos=P())


# ------------------------------------------------------------------ recsys
def recsys_param_specs(params, mesh):
    """Row-shard the stacked embedding table; replicate MLPs."""

    def spec(node):
        if isinstance(node, EmbedTables):
            return EmbedTables(table=P("model", None), offsets=P())
        if node is None:
            return None
        if isinstance(node, tuple):  # a NamedTuple of parameters, or an MLP's tuple of layers
            return type(node)(*map(spec, node)) if hasattr(node, "_fields") else tuple(map(spec, node))
        return P()

    return spec(params)


def recsys_batch_spec(mesh, batch: int, candidates: bool = False):
    b = _batch(mesh)
    if candidates:
        return P("model", None)  # candidate set sharded over model
    return P(b, None)


# ------------------------------------------------------------------ GNN
def gnn_specs(mesh):
    all_axes = tuple(mesh.axis_names)
    return {
        "node": P(),  # replicated node arrays
        "edge": P(all_axes),  # edge-parallel over every axis
        "batch_graphs": P(_batch(mesh)),
    }


# ------------------------------------------------------------------ retrieval index
def index_specs(index: LSPIndex, mesh) -> LSPIndex:
    """LSPIndex specs: unit dims over `model`, vocab-major packed rows whole."""

    def pb(x: PackedBounds) -> PackedBounds:
        return PackedBounds(
            packed=P(None, "model"), bits=x.bits, scale=x.scale, n=x.n, granule_words=x.granule_words
        )

    return LSPIndex(
        b=index.b,
        c=index.c,
        n_docs=index.n_docs,
        vocab=index.vocab,
        n_blocks=index.n_blocks,
        n_superblocks=index.n_superblocks,
        sb_bounds=pb(index.sb_bounds),
        blk_bounds=pb(index.blk_bounds),
        sb_avg=None if index.sb_avg is None else pb(index.sb_avg),
        docs_fwd=FwdDocs(
            tids=P("model", None), ws=P("model", None), scale=index.docs_fwd.scale, t_max=index.docs_fwd.t_max
        ),
        docs_flat=None
        if index.docs_flat is None
        else FlatInv(
            tids=P("model"),
            local_dids=P("model"),
            ws=P("model"),
            block_ptr=P("model"),
            max_block_nnz=index.docs_flat.max_block_nnz,
            scale=index.docs_flat.scale,
        ),
        doc_remap=P("model"),
        docs_fwdq=None
        if index.docs_fwdq is None
        else FwdDocsQ(
            tids=P("model", None, None),
            ws=P("model", None, None),
            scales=P("model"),
            bits=index.docs_fwdq.bits,
            t_pad=index.docs_fwdq.t_pad,
        ),
        docs_flatq=None
        if index.docs_flatq is None
        else FlatDocsQ(
            tids=P("model", None),
            ws=P("model", None),
            doc_ends=P("model", None),
            scales=P("model"),
            bits=index.docs_flatq.bits,
            m=index.docs_flatq.m,
        ),
    )


# ------------------------------------------------------------------ placements
class NamedSharding:
    """A placement: ``spec``'s dimensions split over the axes of ``mesh``.
    Index maps need only the mesh's shape; ``shard``, ``gather`` and
    ``reshard`` need a ``DeviceMesh``, and run on its device."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def _dim_axes(self, ndim: int) -> list:
        """Each dimension's axes, major to minor."""
        parts = tuple(self.spec)
        if len(parts) > ndim:
            raise ValueError(f"{self.spec} has {len(parts)} entries for an array of rank {ndim}")
        out, seen = [], set()
        for p in parts + (None,) * (ndim - len(parts)):
            axes = () if p is None else ((p,) if isinstance(p, str) else tuple(p))
            for a in axes:
                if a not in self.mesh.shape:
                    raise ValueError(f"{self.spec} names axis {a!r}, which {self.mesh} lacks")
                if a in seen:
                    raise ValueError(f"{self.spec} uses axis {a!r} twice")
                seen.add(a)
            out.append(axes)
        return out

    def _factors(self, shape) -> list:
        """Each dimension's (axes, number of shards); a dimension that its
        shards do not divide raises ValueError, as JAX's ``device_put``."""
        out = []
        for d, axes in enumerate(self._dim_axes(len(shape))):
            n = math.prod(self.mesh.shape[a] for a in axes)
            if shape[d] % n:
                raise ValueError(f"{self} splits dimension {d} of shape {tuple(shape)} into {n} shards, which "
                                 f"do not divide {shape[d]}")
            out.append((axes, n))
        return out

    def shard_shape(self, shape) -> tuple:
        return tuple(s // n for s, (_, n) in zip(shape, self._factors(shape)))

    def global_shape(self, local_shape) -> tuple:
        """The whole shape of which ``local_shape`` is a shard."""
        return tuple(s * math.prod(self.mesh.shape[a] for a in axes)
                     for s, axes in zip(local_shape, self._dim_axes(len(local_shape))))

    def indices(self, shape, coord) -> tuple:
        """The slices of a global ``shape`` that the mesh coordinate ``coord``
        holds, in JAX's form: ``slice(None)`` for a whole dimension."""
        out = []
        for d, (axes, n) in enumerate(self._factors(shape)):
            if n == 1:
                out.append(slice(None))
                continue
            idx = 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + coord[self.mesh.axis_names.index(a)]
            step = shape[d] // n
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def devices_indices_map(self, shape) -> dict:
        """{coordinate: slices} over every coordinate of the mesh, in rank order."""
        return {coord: self.indices(shape, coord) for coord in self.mesh.coords()}

    def _box(self, shape, coord) -> tuple:
        return tuple(s.indices(n)[:2] for s, n in zip(self.indices(shape, coord), shape))

    def local_slice(self, x):
        """This rank's shard of a whole array or tensor (a view of it)."""
        return x[self.indices(tuple(x.shape), self.mesh.coord)]

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor, a copy on the mesh's device
        that holds no reference to ``x`` (``jax.device_put(x, sharding)``)."""
        return self.local_slice(x).to(self.mesh.device, copy=True, memory_format=torch.contiguous_format)

    def gather(self, local: torch.Tensor, dst: Optional[int] = None) -> Optional[torch.Tensor]:
        """The whole tensor assembled from every rank's shard, on every rank
        (or on rank ``dst`` only; None elsewhere), on ``local``'s device.
        Collective over the world."""
        shape = self.global_shape(tuple(local.shape))
        world = self.mesh.size
        if world == 1:
            return local.clone()
        src = to_wire(local, None)
        if dst is None:
            parts = [torch.empty_like(src) for _ in range(world)]
            dist.all_gather(parts, src)
        else:
            parts = [torch.empty_like(src) for _ in range(world)] if self.mesh.rank == dst else None
            dist.gather(src, parts, dst=dst)
            if parts is None:
                return None
        out = src.new_empty(shape)
        for rank, part in enumerate(parts):
            out[self.indices(shape, self.mesh.coord_of(rank))] = part
        return out.to(local.device)


def device_put(x, sharding):
    """Each tensor leaf of ``x`` as this rank's shard under the matching
    placement of ``sharding`` (a placement or a tree of them); other leaves
    pass through."""
    if isinstance(sharding, NamedSharding):
        return sharding.shard(x)
    return tree_map(lambda t, s: s.shard(t) if isinstance(t, torch.Tensor) else t, x, sharding)


def _intersect(a: tuple, b: tuple) -> Optional[tuple]:
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def _rel(box: tuple, origin: tuple) -> tuple:
    return tuple(slice(lo - o0, hi - o0) for (lo, hi), (o0, _) in zip(box, origin))


def reshard(local: torch.Tensor, src: NamedSharding, dst: NamedSharding) -> torch.Tensor:
    """This rank's shard under ``dst`` of the tensor whose shard under ``src``
    is ``local``; both meshes span the same ranks. Each piece a rank needs
    comes once, from itself where it holds it, else from one of the ranks
    that hold it (replicas take turns by the receiving rank). Collective over
    the world: point-to-point sends, through host memory on gloo."""
    shape = src.global_shape(tuple(local.shape))
    world, me = src.mesh.size, src.mesh.rank
    if dst.mesh.size != world or dst.mesh.rank != me:
        raise ValueError(f"{src.mesh} and {dst.mesh} must span the same ranks")
    src_boxes = [src._box(shape, src.mesh.coord_of(r)) for r in range(world)]
    dst_boxes = [dst._box(shape, dst.mesh.coord_of(r)) for r in range(world)]
    holders: dict = {}
    for r, box in enumerate(src_boxes):
        holders.setdefault(box, []).append(r)
    out = torch.empty(dst.shard_shape(shape), dtype=local.dtype, device=local.device)
    wire = wire_device(local, None) if world > 1 else local.device
    ops, received = [], []
    for d in range(world):
        for tag, (box, hs) in enumerate(holders.items()):
            piece = _intersect(box, dst_boxes[d])
            if piece is None:
                continue
            h = d if d in hs else hs[d % len(hs)]
            if h == me and d == me:
                out[_rel(piece, dst_boxes[me])] = local[_rel(piece, box)]
            elif h == me:
                t = local[_rel(piece, box)].contiguous()
                ops.append(dist.P2POp(dist.isend, t.to(wire), d, tag=tag))
            elif d == me:
                buf = torch.empty(tuple(hi - lo for lo, hi in piece), dtype=local.dtype,
                                  device=wire)
                ops.append(dist.P2POp(dist.irecv, buf, h, tag=tag))
                received.append((piece, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for piece, buf in received:
        out[_rel(piece, dst_boxes[me])] = buf.to(local.device)
    return out


def gather_tree(state, shardings, dst: Optional[int] = None):
    """Every tensor leaf of a tree of shards gathered into the whole (on
    every rank, or on ``dst`` only; elsewhere the tree holds None)."""
    return tree_map(lambda t, s: s.gather(t, dst) if isinstance(t, torch.Tensor) else t, state, shardings)

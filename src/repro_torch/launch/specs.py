"""Cell builder: (arch, shape, mesh) -> step function, its inputs and their
placements. The dry run (``launch/dryrun.py``) counts every cell's step.

The port of the JAX package's ``launch/specs.py``. Step kinds:
  LM       train_4k -> train_step (remat + grad-accum + Adafactor)
           prefill_32k -> prefill (last-token logits + KV caches)
           decode_32k / long_500k -> serve_step (1 token, KV cache in/out)
  GNN      full_graph/ogb -> full-batch node-classification train_step
           minibatch_lg -> sampled-subgraph train_step; molecule -> energy train_step
  RecSys   train_batch -> train_step (vocab-parallel embeddings)
           serve_p99 / serve_bulk -> forward scoring
           retrieval_cand -> LSP dense-index retrieval (mind) / exhaustive (others)

Nothing is allocated: the parameters come from the ``init_*`` functions on
the ``meta`` device and the inputs are ``meta`` tensors (JAX's
``ShapeDtypeStruct``s; uint32 words are int32 bits, as everywhere in the
port). The placements are ``distributed/sharding.py``'s ``NamedSharding`` on a
``launch.mesh.MeshShape`` or ``DeviceMesh``.

A cell's ``fn`` computes the global step in one process: eager PyTorch has
no SPMD partitioner to split it over the mesh. On a ``DeviceMesh`` the
recsys lookups run through the vocab-parallel functions of
``distributed/embedding.py`` on this rank's table and batch shards (at one
rank, the whole table); on a ``MeshShape`` (the meta pass) they run
``field_lookup`` on the whole table, which is what those functions compute
at one rank. ``donate`` keeps JAX's argnums: the step updates those
arguments in place (the trainer's parameters and moments, the decode
caches). The GSPMD hint ``cast_specs`` of JAX's LM train step has no eager
counterpart and is left out, as in ``models/stacked.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.common.tree_utils import tree_cast, tree_leaves, tree_map
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed import sharding as shr
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.launch.mesh import DeviceMesh, batch_axes
from repro_torch.optim.adafactor import Adafactor, AdafactorState

META = torch.device("meta")


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple  # meta tensors
    in_shardings: tuple
    out_shardings: Any
    note: str = ""
    donate: tuple = ()  # argnums updated in place (params/opt for train, KV for decode)


def _named(mesh, spec_tree):
    """A spec tree as placements; an absent spec (None) is replicated, as
    JAX's ``_named`` makes it."""
    if spec_tree is None:
        return NamedSharding(mesh, P())
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _named(mesh, v) for k, v in spec_tree.items()}
    if hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(_named(mesh, v) for v in spec_tree))
    return type(spec_tree)(_named(mesh, v) for v in spec_tree)


def _replicated(tree):
    return tree_map(lambda _: P(), tree)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _n_batch_shards(mesh) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


def _value_and_grad(loss_fn, params, *args):
    """(loss, float32 gradient tree) of ``loss_fn(params, *args)``; a float
    leaf the loss does not reach gets zeros (``jax.grad``), a non-float leaf
    None (``allow_int``'s float0)."""
    gp = tree_map(lambda x: x.detach().requires_grad_() if torch.is_floating_point(x) else x, params)
    loss = loss_fn(gp, *args)
    leaves = [x for x in tree_leaves(gp) if torch.is_floating_point(x)]
    flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))
    return loss.detach(), tree_map(lambda x: next(flat).float() if torch.is_floating_point(x) else None, gp)


# ===================================================================== LM cells
_LM_ACCUM = {  # grad-accum per arch (activation-memory control at 4k seq)
    "llama4-maverick-400b-a17b": 8,
    "phi3.5-moe-42b-a6.6b": 8,
    "gemma3-27b": 8,
    "granite-3-8b": 8,
    "qwen3-4b": 4,
}


def lm_accum(arch: ArchConfig) -> int:
    return _LM_ACCUM.get(arch.name, 4)


def _lm_train_cell(arch: ArchConfig, shape: ShapeSpec, mesh) -> Cell:
    from repro_torch.models.stacked import init_lm_stacked, lm_loss_stacked

    cfg = arch.lm
    opt = Adafactor(lr=1e-3)
    accum = lm_accum(arch)
    bsz, seq = shape.global_batch, shape.seq_len
    micro = bsz // accum

    def step(params, opt_state, tokens, labels, micro_batches=accum):
        # bf16 cast per group inside the layer loop (cast_dtype): no resident
        # bf16 replica; the float32 gradients of the micro-batches accumulate
        # in the leaves' .grad, summed in micro-batch order as JAX's scan adds
        # them. micro_batches < accum runs only the first ones (the dry run
        # counts 1 and 2 and extrapolates: every later one dispatches the same ops)
        gp = tree_map(lambda x: x.detach().requires_grad_() if torch.is_floating_point(x) else x, params)
        tks = tokens.reshape(accum, micro, seq)
        lbs = labels.reshape(accum, micro, seq)
        loss_sum = 0.0
        for i in range(micro_batches):
            loss = lm_loss_stacked(gp, cfg, tks[i], lbs[i], remat=True, cast_dtype=torch.bfloat16)[0]
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        grads = tree_map(lambda x: (x.grad.div_(accum) if x.grad is not None else torch.zeros_like(x))
                         if torch.is_floating_point(x) else None, gp)
        del gp
        new_p, new_s, _ = opt.update(grads, opt_state, params)
        return new_p, new_s, loss_sum / accum

    params_s = init_lm_stacked(cfg, device=META)
    opt_s = opt.init(params_s)
    tokens_s = _meta((bsz, seq), torch.int32)

    pspec = shr.stacked_lm_param_specs(params_s, mesh, fsdp=True, kv_shard=False)
    ospec = _adafactor_specs(pspec)
    bspec = P(batch_axes(mesh), None)
    return Cell(
        arch.name,
        shape.name,
        "train_step",
        step,
        (params_s, opt_s, tokens_s, tokens_s),
        (_named(mesh, pspec), _named(mesh, ospec), NamedSharding(mesh, bspec), NamedSharding(mesh, bspec)),
        (_named(mesh, pspec), _named(mesh, ospec), NamedSharding(mesh, P())),
        note=f"grad_accum={accum}, remat per layer, Adafactor, bf16 compute / fp32 master",
        donate=(0, 1),
    )


def _adafactor_specs(param_specs):
    return AdafactorState(step=P(), moments=shr.adafactor_state_specs(param_specs))


def _lm_prefill_cell(arch: ArchConfig, shape: ShapeSpec, mesh) -> Cell:
    from repro_torch.models.stacked import init_decode_state_stacked, init_lm_stacked, lm_prefill_stacked

    cfg = arch.lm
    bsz, seq = shape.global_batch, shape.seq_len

    @torch.no_grad()
    def step(params, tokens):
        logits, state = lm_prefill_stacked(tree_cast(params, torch.bfloat16), cfg, tokens, max_len=seq)
        return logits[:, -1:, :], state

    params_s = init_lm_stacked(cfg, device=META)
    tokens_s = _meta((bsz, seq), torch.int32)
    state_s = init_decode_state_stacked(cfg, bsz, seq, device=META)  # the caches the prefill fills

    pspec = shr.stacked_lm_param_specs(params_s, mesh, fsdp=True, kv_shard=True)
    bspec = P(batch_axes(mesh), None)
    state_spec = shr.decode_state_specs(state_s, mesh, bsz, cfg.n_kv_heads, stacked=True)
    return Cell(
        arch.name,
        shape.name,
        "prefill_step",
        step,
        (params_s, tokens_s),
        (_named(mesh, pspec), NamedSharding(mesh, bspec)),
        (NamedSharding(mesh, P(batch_axes(mesh), None, "model")), _named(mesh, state_spec)),
        note="returns last-token logits + populated KV caches",
    )


def _lm_decode_cell(arch: ArchConfig, shape: ShapeSpec, mesh) -> Cell:
    from repro_torch.models.stacked import init_decode_state_stacked, init_lm_stacked, lm_decode_step_stacked

    cfg = arch.lm
    bsz, seq = shape.global_batch, shape.seq_len

    @torch.no_grad()
    def step(params, token, state):
        return lm_decode_step_stacked(tree_cast(params, torch.bfloat16), cfg, token, state)

    params_s = init_lm_stacked(cfg, device=META)
    token_s = _meta((bsz, 1), torch.int32)
    state_s = init_decode_state_stacked(cfg, bsz, seq, device=META)

    pspec = shr.stacked_lm_param_specs(params_s, mesh, fsdp=True, kv_shard=True)
    state_spec = shr.decode_state_specs(state_s, mesh, bsz, cfg.n_kv_heads, stacked=True)
    if bsz >= _n_batch_shards(mesh):
        bspec = P(batch_axes(mesh), None)
        logits_spec = P(batch_axes(mesh), None, "model")
        seq_note = "batch-sharded KV"
    else:
        bspec = P(None, None)  # batch too small to shard; KV length shards instead
        logits_spec = P(None, None, "model")
        seq_note = "sequence-parallel KV (batch < shards)"
    return Cell(
        arch.name,
        shape.name,
        "serve_step",
        step,
        (params_s, token_s, state_s),
        (_named(mesh, pspec), NamedSharding(mesh, bspec), _named(mesh, state_spec)),
        (NamedSharding(mesh, logits_spec), _named(mesh, state_spec)),
        note=f"1 new token vs {seq}-long KV cache; {seq_note}",
        donate=(2,),
    )


# ===================================================================== GNN cells
def _gnn_cell(arch: ArchConfig, shape: ShapeSpec, mesh) -> Cell:
    from repro_torch.models.schnet import init_schnet, molecule_batch_forward, schnet_forward, schnet_readout

    cfg = arch.gnn
    opt = Adafactor(lr=1e-3)
    all_axes = tuple(mesh.axis_names)
    n_classes = 47 if shape.name == "ogb_products" else 16

    if shape.kind == "batched_graphs":
        b, n, e = shape.batch, shape.n_nodes, shape.n_edges
        in_dim = 16  # atom-type one-hot width

        def loss_fn(params, z, pos, es, ed, em, y):
            pred = molecule_batch_forward(params, cfg, z, pos, es, ed, em)
            return torch.mean(torch.square(pred[:, 0] - y))

        def step(params, opt_state, z, pos, es, ed, em, y):
            loss, g = _value_and_grad(loss_fn, params, z, pos, es, ed, em, y)
            new_p, new_s, _ = opt.update(g, opt_state, params)
            return new_p, new_s, loss

        params_s = init_schnet(cfg, in_dim, 1, device=META)
        opt_s = opt.init(params_s)
        args = (
            params_s,
            opt_s,
            _meta((b, n, in_dim), torch.float32),
            _meta((b, n, 3), torch.float32),
            _meta((b, e), torch.int32),
            _meta((b, e), torch.int32),
            _meta((b, e), torch.bool),
            _meta((b,), torch.float32),
        )
        bspec = batch_axes(mesh)
        pspec, ospec = _replicated(params_s), _replicated(opt_s)
        in_sh = (
            _named(mesh, pspec),
            _named(mesh, ospec),
            NamedSharding(mesh, P(bspec, None, None)),
            NamedSharding(mesh, P(bspec, None, None)),
            NamedSharding(mesh, P(bspec, None)),
            NamedSharding(mesh, P(bspec, None)),
            NamedSharding(mesh, P(bspec, None)),
            NamedSharding(mesh, P(bspec)),
        )
        return Cell(
            arch.name, shape.name, "train_step", step, args, in_sh,
            (_named(mesh, pspec), _named(mesh, ospec), NamedSharding(mesh, P())),
            note="batched molecular graphs, energy MSE",
            donate=(0, 1),
        )

    # full-graph or sampled-minibatch node classification
    if shape.kind == "minibatch":
        from repro_torch.data.graph import SampledSubgraph

        shp = SampledSubgraph.shapes(shape.batch_nodes, shape.fanout, 100)
        n_nodes, d_feat = shp["node_feats"]
        n_edges = shp["edge_src"][0]
        n_out = shape.batch_nodes
        note = f"sampled 2-hop subgraph (fanout {shape.fanout}), {n_nodes} nodes/{n_edges} edges"
    else:
        n_nodes, d_feat = shape.n_nodes, shape.d_feat
        n_edges = shape.n_edges
        n_out = shape.n_nodes
        note = "full-batch; edge-parallel over all mesh axes, node arrays replicated"
    # even edge shards: pad the edge arrays to the mesh size (padded edges
    # carry edge_mask=False in the data pipeline)
    n_edges = -(-n_edges // mesh.size) * mesh.size

    def loss_fn(params, x, es, ed, ew, em, labels, label_mask):
        h = schnet_forward(params, cfg, x, es, ed, ew, em)
        logits = schnet_readout(params, h)[: labels.shape[0]].float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
        ce = torch.where(label_mask, logz - gold, torch.zeros((), dtype=logz.dtype, device=logz.device))
        return ce.sum() / torch.clamp_min(label_mask.sum(), 1)

    def step(params, opt_state, x, es, ed, ew, em, labels, label_mask):
        loss, g = _value_and_grad(loss_fn, params, x, es, ed, ew, em, labels, label_mask)
        new_p, new_s, _ = opt.update(g, opt_state, params)
        return new_p, new_s, loss

    params_s = init_schnet(cfg, d_feat, n_classes, device=META)
    opt_s = opt.init(params_s)
    args = (
        params_s,
        opt_s,
        _meta((n_nodes, d_feat), torch.float32),
        _meta((n_edges,), torch.int32),
        _meta((n_edges,), torch.int32),
        _meta((n_edges,), torch.float32),
        _meta((n_edges,), torch.bool),
        _meta((n_out,), torch.int32),
        _meta((n_out,), torch.bool),
    )
    pspec, ospec = _replicated(params_s), _replicated(opt_s)
    espec = NamedSharding(mesh, P(all_axes))
    in_sh = (
        _named(mesh, pspec),
        _named(mesh, ospec),
        NamedSharding(mesh, P(None, None)),  # node features replicated
        espec, espec, espec, espec,
        NamedSharding(mesh, P(None)),
        NamedSharding(mesh, P(None)),
    )
    return Cell(
        arch.name, shape.name, "train_step", step, args, in_sh,
        (_named(mesh, pspec), _named(mesh, ospec), NamedSharding(mesh, P())),
        note=note,
        donate=(0, 1),
    )


# ===================================================================== recsys cells
def _recsys_batch_arrays(arch: ArchConfig, batch: int) -> dict:
    rc = arch.recsys
    if arch.name.startswith("dlrm"):
        return {
            "dense": _meta((batch, rc.n_dense), torch.float32),
            "sparse_ids": _meta((batch, rc.n_sparse), torch.int32),
            "labels": _meta((batch,), torch.float32),
        }
    if arch.name == "din":
        return {
            "target_ids": _meta((batch, rc.n_sparse), torch.int32),
            "hist_ids": _meta((batch, rc.hist_len, rc.n_sparse), torch.int32),
            "hist_mask": _meta((batch, rc.hist_len), torch.bool),
            "labels": _meta((batch,), torch.float32),
        }
    return {  # mind
        "target_ids": _meta((batch, rc.n_sparse), torch.int32),
        "hist_ids": _meta((batch, rc.hist_len, rc.n_sparse), torch.int32),
        "hist_mask": _meta((batch, rc.hist_len), torch.bool),
    }


def _recsys_forward(arch: ArchConfig, mesh, use_vp):
    """(init(device), fwd(params, batch), loss(params, batch)).

    ``use_vp``: "scatter" for the reduce-scatter lookup, True for the
    all-reduce one, False for ``field_lookup``."""
    import repro_torch.models.recsys as R

    rc = arch.recsys
    baxes = batch_axes(mesh)

    def lookup(tables, ids2d):
        if use_vp and isinstance(mesh, DeviceMesh):
            from repro_torch.distributed.embedding import vocab_parallel_lookup, vocab_parallel_lookup_scattered

            fn = vocab_parallel_lookup_scattered if use_vp == "scatter" else vocab_parallel_lookup
            return fn(tables.table, ids2d + tables.offsets[None, :], mesh, baxes)
        return R.field_lookup(tables, ids2d)

    if arch.name.startswith("dlrm"):
        def init(device):
            return R.init_dlrm(rc, device=device)

        def fwd(params, batch):
            bot = R._mlp(params.bot, batch["dense"], final_act=True)
            embs = lookup(params.tables, batch["sparse_ids"])
            z = torch.cat([bot[:, None, :], embs], dim=1)
            gram = torch.einsum("bfd,bgd->bfg", z, z)
            iu, ju = torch.triu_indices(z.shape[1], z.shape[1], 1, device=z.device)
            pairs = gram[:, iu, ju]
            return R._mlp(params.top, torch.cat([bot, pairs], dim=1))[:, 0]

        def loss(params, batch):
            return R.bce_loss(fwd(params, batch), batch["labels"])

        return init, fwd, loss

    if arch.name == "din":
        def init(device):
            return R.init_din(rc, device=device)

        def fwd(params, batch):
            b = batch["target_ids"].shape[0]
            t = lookup(params.tables, batch["target_ids"]).reshape(b, -1)
            hl, nf = batch["hist_ids"].shape[1:]
            h = lookup(params.tables, batch["hist_ids"].reshape(b * hl, nf)).reshape(b, hl, -1)
            tb = t[:, None, :].expand_as(h)
            a_in = torch.cat([h, tb, h - tb, h * tb], dim=-1)
            scores = R._mlp(params.attn, a_in)[..., 0] * batch["hist_mask"].to(torch.float32)
            interest = torch.einsum("bl,bli->bi", scores, h)
            return R._mlp(params.top, torch.cat([interest, t], dim=-1))[:, 0]

        def loss(params, batch):
            return R.bce_loss(fwd(params, batch), batch["labels"])

        return init, fwd, loss

    def init(device):
        return R.init_mind(rc, device=device)

    def interests_fn(params, batch):
        b, hl, nf = batch["hist_ids"].shape
        h = lookup(params.tables, batch["hist_ids"].reshape(b * hl, nf)).reshape(b, hl, -1)
        h = h @ params.s_bilinear
        b_mask = (batch["hist_mask"].to(torch.float32) - 1.0) * 1e9
        blk = R._routing_init(hl, rc.n_interests).to(h.device)  # jax.random.normal(PRNGKey(0), (1, L, K))
        b_rout = blk.expand(b, hl, rc.n_interests)
        interests = None
        for it in range(rc.capsule_iters):
            w = torch.softmax(b_rout + b_mask[..., None], dim=-1)
            z = torch.einsum("blk,bld->bkd", w, h)
            interests = R._squash(z)
            if it < rc.capsule_iters - 1:  # the last update is read by nothing (XLA drops it too)
                b_rout = b_rout + torch.einsum("bkd,bld->blk", interests.detach(), h)
        return interests

    def loss(params, batch):
        b = batch["target_ids"].shape[0]
        ints = interests_fn(params, batch)
        te = lookup(params.tables, batch["target_ids"]).reshape(b, -1) @ params.s_bilinear
        uv = R.mind_user_vector(params, rc, ints, te)
        return R.sampled_softmax_loss(uv, te)

    return init, interests_fn, loss


def _recsys_param_specs(params_s):
    from repro_torch.models.recsys import EmbedTables

    def fix(p):
        if isinstance(p, EmbedTables):
            return EmbedTables(table=P("model", None), offsets=P(None))
        return _replicated(p)

    return type(params_s)(*[fix(f) for f in params_s])


def _recsys_cell(arch: ArchConfig, shape: ShapeSpec, mesh) -> Cell:
    baxes = batch_axes(mesh)
    init, fwd, loss = _recsys_forward(arch, mesh, use_vp="scatter" if shape.kind == "rank_train" else True)
    params_s = init(META)
    pspec = _recsys_param_specs(params_s)
    batch_arrays = _recsys_batch_arrays(arch, shape.batch)
    bshard = {k: NamedSharding(mesh, P(baxes, *([None] * (v.dim() - 1)))) for k, v in batch_arrays.items()}

    if shape.kind == "rank_train":
        opt = Adafactor(lr=1e-3)
        opt_s = opt.init(params_s)
        ospec = _adafactor_specs(pspec)

        def step(params, opt_state, batch):
            l, g = _value_and_grad(loss, params, batch)
            new_p, new_s, _ = opt.update(g, opt_state, params)
            return new_p, new_s, l

        return Cell(
            arch.name, shape.name, "train_step", step,
            (params_s, opt_s, batch_arrays),
            (_named(mesh, pspec), _named(mesh, ospec), bshard),
            (_named(mesh, pspec), _named(mesh, ospec), NamedSharding(mesh, P())),
            note="vocab-parallel embedding (psum over model), Adafactor",
            donate=(0, 1),
        )

    if shape.kind == "rank_serve":
        arrays = {k: v for k, v in batch_arrays.items() if k != "labels"}
        ashard = {k: bshard[k] for k in arrays}

        @torch.no_grad()
        def step(params, batch):
            return fwd(params, batch)

        out_spec = (
            NamedSharding(mesh, P(baxes, None, None)) if arch.name == "mind" else NamedSharding(mesh, P(baxes))
        )
        return Cell(
            arch.name, shape.name, "serve_step", step, (params_s, arrays),
            (_named(mesh, pspec), ashard), out_spec,
            note="forward scoring only",
        )

    return _recsys_retrieval_cell(arch, shape, mesh, params_s, pspec)


# mind's dense LSP layout, per shard: b, c, bits, the dequant scale and zero point
MIND_B, MIND_C, MIND_BITS, MIND_SCALE, MIND_ZERO = 64, 16, 4, 0.01, -1.0


def _recsys_retrieval_cell(arch: ArchConfig, shape: ShapeSpec, mesh, params_s, pspec) -> Cell:
    """batch=1 user, 1M candidates.

    mind: the paper's technique — dense LSP (superblock-pruned) candidate
    scoring, each model shard a dense index of its own (the host loop of
    ``make_sharded_dense_retriever``). din/dlrm: non-dot interactions ->
    exhaustive scoring, candidates model-sharded.
    """
    rc = arch.recsys
    n_cand = shape.n_candidates

    if arch.name == "mind":
        from repro_torch.core.config import RetrievalConfig
        from repro_torch.core.lsp_dense import DenseLSPIndex, PackedMinMax, make_sharded_dense_retriever
        from repro_torch.index.pack import SEG_WORDS

        d = rc.embed_dim
        b_, c_ = MIND_B, MIND_C
        n_shards = mesh.shape["model"]
        ns = -(-n_cand // (b_ * c_))
        ns = -(-ns // n_shards) * n_shards
        ns_l = ns // n_shards  # per-shard superblocks
        nb_l = ns_l * c_
        np_l = nb_l * b_
        vpw = 32 // MIND_BITS
        sb_words_l = -(-ns_l // (SEG_WORDS * vpw)) * SEG_WORDS  # per-shard sb row, SEG granule
        cw = c_ * MIND_BITS // 32
        gamma_ = max(1, min(32, ns_l))
        cfg = RetrievalConfig(variant="lsp0", k=100, gamma=gamma_, gamma0=min(8, gamma_))

        def step(sb_max, sb_min, blk_max, blk_min, cands, remap, q, impl="auto"):
            shards = [
                DenseLSPIndex(
                    b=b_, c=c_, n_cands=n_cand, dim=d, n_blocks=nb_l, n_superblocks=ns_l,
                    sb=PackedMinMax(sb_max[s], sb_min[s], MIND_SCALE, MIND_ZERO, ns_l, SEG_WORDS, MIND_BITS),
                    blk=PackedMinMax(blk_max[s], blk_min[s], MIND_SCALE, MIND_ZERO, nb_l, cw, MIND_BITS),
                    cands=cands[s], remap=remap[s],
                )
                for s in range(n_shards)
            ]
            return make_sharded_dense_retriever(shards, cfg, impl=impl)(q)

        step.n_cands = n_cand  # the candidates behind the padded layout (dryrun.draw_args reads it)
        args = (
            _meta((n_shards, d, sb_words_l), torch.int32),
            _meta((n_shards, d, sb_words_l), torch.int32),
            _meta((n_shards, d, ns_l * cw), torch.int32),
            _meta((n_shards, d, ns_l * cw), torch.int32),
            _meta((n_shards, np_l, d), torch.bfloat16),
            _meta((n_shards, np_l), torch.int32),
            _meta((rc.n_interests, d), torch.float32),  # batch=1 user's K interests
        )
        in_sh = tuple(NamedSharding(mesh, P("model", None, None)) for _ in range(5)) + (
            NamedSharding(mesh, P("model", None)),
            NamedSharding(mesh, P(None, None)),
        )
        return Cell(
            arch.name, shape.name, "retrieve_step", step, args, in_sh,
            (NamedSharding(mesh, P(None, None)), NamedSharding(mesh, P(None, None))),
            note="dense LSP (the paper's technique) over 1M candidates, one dense index per model shard, "
            "hierarchical top-k (per-shard gamma, O(P*k) merge)",
        )

    # din / dlrm: exhaustive candidate scoring, candidates sharded over model
    _, fwd, _ = _recsys_forward(arch, mesh, use_vp=False)

    if arch.name == "din":
        @torch.no_grad()
        def step(params, cand_ids, hist_ids, hist_mask):
            out = []
            for lo in range(0, cand_ids.shape[0], 4096):  # jax.lax.map(..., batch_size=4096)
                cid = cand_ids[lo: lo + 4096]
                n = cid.shape[0]
                batch = {
                    "target_ids": cid,
                    "hist_ids": hist_ids[None].expand(n, *hist_ids.shape),
                    "hist_mask": hist_mask[None].expand(n, *hist_mask.shape),
                }
                out.append(fwd(params, batch))
            return torch.cat(out)

        args = (
            params_s,
            _meta((n_cand, rc.n_sparse), torch.int32),
            _meta((rc.hist_len, rc.n_sparse), torch.int32),
            _meta((rc.hist_len,), torch.bool),
        )
        in_sh = (
            _named(mesh, pspec),
            NamedSharding(mesh, P("model", None)),
            NamedSharding(mesh, P(None, None)),
            NamedSharding(mesh, P(None)),
        )
        return Cell(
            arch.name, shape.name, "retrieve_step", step, args, in_sh,
            NamedSharding(mesh, P("model")),
            note="1 user x 1M candidates, per-candidate target attention (chunked)",
        )

    @torch.no_grad()
    def step(params, dense, sparse_ids, cand_ids):
        # fixed user features; the candidate id replaces the item field (field 0)
        out = []
        for lo in range(0, cand_ids.shape[0], 8192):  # jax.lax.map(..., batch_size=8192)
            cid = cand_ids[lo: lo + 8192]
            n = cid.shape[0]
            ids = sparse_ids.expand(n, sparse_ids.shape[1]).clone()
            ids[:, 0] = cid
            out.append(fwd(params, {"dense": dense.expand(n, dense.shape[1]), "sparse_ids": ids}))
        return torch.cat(out)

    args = (
        params_s,
        _meta((1, rc.n_dense), torch.float32),
        _meta((1, rc.n_sparse), torch.int32),
        _meta((n_cand,), torch.int32),
    )
    in_sh = (
        _named(mesh, pspec),
        NamedSharding(mesh, P(None, None)),
        NamedSharding(mesh, P(None, None)),
        NamedSharding(mesh, P("model")),
    )
    return Cell(
        arch.name, shape.name, "retrieve_step", step, args, in_sh,
        NamedSharding(mesh, P("model")),
        note="1 user x 1M candidates, item field swept (chunked)",
    )


# ===================================================================== entry point
def cell_for_shape(arch: ArchConfig, shape: ShapeSpec, mesh) -> Cell:
    """The cell of ``arch`` at ``shape`` (any ``ShapeSpec`` of its family)."""
    if arch.family == "lm":
        if shape.kind == "train":
            return _lm_train_cell(arch, shape, mesh)
        if shape.kind == "prefill":
            return _lm_prefill_cell(arch, shape, mesh)
        return _lm_decode_cell(arch, shape, mesh)
    if arch.family == "gnn":
        return _gnn_cell(arch, shape, mesh)
    return _recsys_cell(arch, shape, mesh)


def build_cell(arch: ArchConfig, shape_name: str, mesh) -> Optional[Cell]:
    if shape_name in arch.skip_shapes:
        return None
    return cell_for_shape(arch, arch.shapes[shape_name], mesh)

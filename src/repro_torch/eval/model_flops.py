"""Analytic MODEL_FLOPS per (arch x shape): the 'useful' FLOPs of the workload.

LM train: 6 * N_active * tokens (+ attention);  decode: 2 * N_active * batch
(+ KV attention);  prefill: 2 * N_active * tokens (+ causal attention).
GNN / recsys: per-op analytic counts, x3 for training (fwd + bwd ~ 2x fwd).
Used for the §Roofline MODEL_FLOPS / HLO_FLOPs ratio (remat/redundancy waste).
Takes an ``ArchConfig`` (the registry's arch files are not ported yet).
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data.graph import SampledSubgraph
from repro_torch.models.attention import layer_kind
from repro_torch.models.transformer import is_moe_layer


def lm_active_params(cfg) -> float:
    """Per-token active parameter count (matmul weights only, incl. LM head)."""
    hd = cfg.resolved_head_dim()
    total = 0.0
    for i in range(cfg.n_layers):
        attn = cfg.d_model * cfg.n_heads * hd + 2 * cfg.d_model * cfg.n_kv_heads * hd + cfg.n_heads * hd * cfg.d_model
        if is_moe_layer(cfg, i):
            moe = cfg.moe
            ffn = moe.top_k * 3 * cfg.d_model * moe.d_ff_expert
            ffn += moe.n_shared * 3 * cfg.d_model * moe.d_ff_expert
            ffn += cfg.d_model * moe.n_experts  # router
        else:
            ffn = 3 * cfg.d_model * cfg.d_ff
        total += attn + ffn
    total += cfg.d_model * cfg.vocab  # head (tied or not, the matmul happens)
    return total


def lm_total_params(cfg) -> float:
    hd = cfg.resolved_head_dim()
    total = cfg.vocab * cfg.d_model
    for i in range(cfg.n_layers):
        attn = cfg.d_model * cfg.n_heads * hd + 2 * cfg.d_model * cfg.n_kv_heads * hd + cfg.n_heads * hd * cfg.d_model
        if is_moe_layer(cfg, i):
            moe = cfg.moe
            ffn = moe.n_experts * 3 * cfg.d_model * moe.d_ff_expert
            ffn += moe.n_shared * 3 * cfg.d_model * moe.d_ff_expert + cfg.d_model * moe.n_experts
        else:
            ffn = 3 * cfg.d_model * cfg.d_ff
        total += attn + ffn
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab
    return total


def _attn_ctx(cfg, layer: int, seq: int) -> float:
    """Effective context length of a layer at full seq (window-limited for local)."""
    kind = layer_kind(cfg, layer)
    if kind in ("swa", "chunked") and cfg.window:
        return min(cfg.window, seq)
    return seq


def lm_flops(cfg, shape: ShapeSpec) -> float:
    hd = cfg.resolved_head_dim()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        core = 6.0 * lm_active_params(cfg) * tokens
        attn = 0.0
        for i in range(cfg.n_layers):
            ctx = _attn_ctx(cfg, i, shape.seq_len)
            # qk + pv, causal half, x3 for bwd
            attn += 3.0 * 2.0 * 2.0 * cfg.n_heads * hd * tokens * ctx / 2
        return core + attn
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        core = 2.0 * lm_active_params(cfg) * tokens
        attn = sum(
            2.0 * 2.0 * cfg.n_heads * hd * tokens * _attn_ctx(cfg, i, shape.seq_len) / 2
            for i in range(cfg.n_layers)
        )
        return core + attn
    # decode: one token against the cache
    core = 2.0 * lm_active_params(cfg) * shape.global_batch
    attn = sum(
        2.0 * 2.0 * cfg.n_heads * hd * shape.global_batch * _attn_ctx(cfg, i, shape.seq_len)
        for i in range(cfg.n_layers)
    )
    return core + attn


def _mlp_flops(dims: tuple, batch: float) -> float:
    return sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:])) * batch


def recsys_flops(arch: ArchConfig, shape: ShapeSpec) -> float:
    rc = arch.recsys
    d = rc.embed_dim
    if arch.name.startswith("dlrm"):
        nf = rc.n_sparse + 1
        pairs_in = d + nf * (nf - 1) // 2
        fwd = lambda b: (
            _mlp_flops((rc.n_dense,) + rc.bot_mlp, b)
            + 2.0 * nf * nf * d * b  # gram interaction
            + _mlp_flops((pairs_in,) + rc.top_mlp, b)
        )
    elif arch.name == "din":
        item = rc.n_sparse * d
        fwd = lambda b: (
            _mlp_flops((4 * item,) + rc.attn_mlp + (1,), b * rc.hist_len)
            + 2.0 * rc.hist_len * item * b
            + _mlp_flops((2 * item,) + rc.top_mlp, b)
        )
    else:  # mind
        item = rc.n_sparse * d
        fwd = lambda b: (
            2.0 * rc.hist_len * item * d * b  # bilinear
            + rc.capsule_iters * 2.0 * 2.0 * rc.hist_len * rc.n_interests * d * b
        )
    if shape.kind == "rank_train":
        return 3.0 * fwd(shape.batch)
    if shape.kind == "rank_serve":
        return fwd(shape.batch)
    # retrieval_cand
    if arch.name == "mind":
        return 2.0 * shape.n_candidates * d * rc.n_interests  # dot scoring (post-pruning upper bound)
    if arch.name == "din":
        return fwd(shape.n_candidates)
    return fwd(shape.n_candidates)


def gnn_flops(arch: ArchConfig, shape: ShapeSpec) -> float:
    cfg = arch.gnn
    h, r = cfg.d_hidden, cfg.n_rbf
    if shape.kind == "batched_graphs":
        n = shape.batch * shape.n_nodes
        e = shape.batch * shape.n_edges
    elif shape.kind == "minibatch":
        shp = SampledSubgraph.shapes(shape.batch_nodes, shape.fanout, 100)
        n, e = shp["node_feats"][0], shp["edge_src"][0]
    else:
        n, e = shape.n_nodes, shape.n_edges
    per_inter = 2.0 * e * r * h + 2.0 * e * h * h + 2.0 * e * h + 3 * 2.0 * n * h * h
    fwd = cfg.n_interactions * per_inter + 2.0 * n * (shape.d_feat or 16) * h
    return 3.0 * fwd  # training step


def model_flops(arch: ArchConfig, shape_name: str, shape: ShapeSpec | None = None) -> float:
    """The model FLOPs of ``arch`` at its shape ``shape_name``, or at ``shape``
    where given (a cut of it: a smaller batch, one mesh position's share)."""
    shape = arch.shapes[shape_name] if shape is None else shape
    if arch.family == "lm":
        return lm_flops(arch.lm, shape)
    if arch.family == "recsys":
        return recsys_flops(arch, shape)
    return gnn_flops(arch, shape)

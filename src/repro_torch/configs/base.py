"""Config dataclasses + arch registry.

Every assigned architecture registers an ``ArchConfig`` under its pool id; launchers
select with ``--arch <id>`` and ``--shape <id>``. ``reduced()`` returns a CPU-smoke
variant of the same family (same code paths, tiny dims).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Optional

from repro_torch.common.registry import Registry

ARCHS: Registry = Registry("arch")


# --------------------------------------------------------------------------- shapes
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | full_graph | minibatch | batched_graphs |
    #            rank_train | rank_serve | retrieval
    seq_len: int = 0
    global_batch: int = 0
    # gnn
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple = ()
    n_graphs: int = 0
    # recsys
    batch: int = 0
    n_candidates: int = 0


LM_SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES: Dict[str, ShapeSpec] = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "full_graph", n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "minibatch", n_nodes=232965, n_edges=114615892, batch_nodes=1024, fanout=(15, 10)
    ),
    "ogb_products": ShapeSpec("ogb_products", "full_graph", n_nodes=2449029, n_edges=61859140, d_feat=100),
    "molecule": ShapeSpec("molecule", "batched_graphs", n_nodes=30, n_edges=64, batch=128),
}

RECSYS_SHAPES: Dict[str, ShapeSpec] = {
    "train_batch": ShapeSpec("train_batch", "rank_train", batch=65536),
    "serve_p99": ShapeSpec("serve_p99", "rank_serve", batch=512),
    "serve_bulk": ShapeSpec("serve_bulk", "rank_serve", batch=262144),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000),
}


# --------------------------------------------------------------------------- families
@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    # capacity factor for fixed-shape dispatch (EP-friendly)
    capacity_factor: float = 1.25
    # MoE every n-th layer (llama4 Maverick interleaves dense/MoE with step 2)
    every_n: int = 1


@dataclass(frozen=True)
class LMCfg:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    moe: Optional[MoECfg] = None
    qk_norm: bool = False
    # attention pattern: "full" | "hybrid_swa" (sliding window : global = local_ratio:1)
    # | "hybrid_chunked" (llama4 iRoPE chunked local : NoPE global)
    attn_pattern: str = "full"
    window: int = 0
    local_ratio: int = 0
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


@dataclass(frozen=True)
class GNNCfg:
    n_interactions: int
    d_hidden: int
    n_rbf: int
    cutoff: float
    # dims of the readout MLP
    readout_hidden: int = 32


@dataclass(frozen=True)
class RecsysCfg:
    n_dense: int
    n_sparse: int
    embed_dim: int
    bot_mlp: tuple
    top_mlp: tuple
    interaction: str  # dot | target_attn | multi_interest
    vocab_sizes: tuple  # per sparse field
    # DIN
    hist_len: int = 0
    attn_mlp: tuple = ()
    # MIND
    n_interests: int = 0
    capsule_iters: int = 0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # lm | gnn | recsys
    lm: Optional[LMCfg] = None
    gnn: Optional[GNNCfg] = None
    recsys: Optional[RecsysCfg] = None
    # which shapes this arch skips, with reason (recorded in EXPERIMENTS.md)
    skip_shapes: Dict[str, str] = field(default_factory=dict)
    notes: str = ""

    @property
    def shapes(self) -> Dict[str, ShapeSpec]:
        return {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}[self.family]

    def runnable_shapes(self) -> Dict[str, ShapeSpec]:
        return {k: v for k, v in self.shapes.items() if k not in self.skip_shapes}

    def reduced(self) -> "ArchConfig":
        """CPU-smoke variant: identical code paths, tiny dims."""
        if self.family == "lm":
            lm = self.lm
            moe = None
            if lm.moe is not None:
                moe = replace(lm.moe, n_experts=min(lm.moe.n_experts, 4), d_ff_expert=64)
            lm = replace(
                lm,
                n_layers=2 if lm.local_ratio == 0 else max(2, lm.local_ratio + 1),
                d_model=64,
                n_heads=4,
                n_kv_heads=min(lm.n_kv_heads, 2),
                d_ff=128,
                vocab=512,
                head_dim=16,
                moe=moe,
                window=min(lm.window, 16) if lm.window else 0,
            )
            return replace(self, lm=lm)
        if self.family == "gnn":
            return replace(self, gnn=replace(self.gnn, d_hidden=16, n_rbf=8))
        rc = self.recsys
        embed_dim = min(rc.embed_dim, 8)
        bot = tuple(min(d, 16) for d in rc.bot_mlp)
        if bot:
            bot = bot[:-1] + (embed_dim,)  # bottom-MLP output must match embed_dim
        rc = replace(
            rc,
            embed_dim=embed_dim,
            bot_mlp=bot,
            top_mlp=tuple(min(d, 16) for d in rc.top_mlp[:-1]) + (rc.top_mlp[-1],),
            vocab_sizes=tuple(min(v, 100) for v in rc.vocab_sizes),
            attn_mlp=tuple(min(d, 8) for d in rc.attn_mlp),
        )
        return replace(self, recsys=rc)


def register_arch(cfg: ArchConfig) -> ArchConfig:
    ARCHS.register(cfg.name)(cfg)
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)

    return ARCHS.get(name)


def all_arch_names() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return ARCHS.names()


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)

"""FFN layers: dense SwiGLU and capacity-based top-k MoE (GShard-style dispatch).

The MoE dispatch is the fixed-capacity one-hot product formulation: static
shapes, each expert's queue cut at its capacity. Tokens overflowing an expert's
capacity are dropped (the residual passes through); ``capacity_factor``
controls the drop rate. It is computed as the JAX module computes it, with
three of its traps named where they are met: ``lax.top_k``'s tie order, a
one-hot of a slot past the capacity, and the dtype of the dispatch products.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.common import module as nn
from repro_torch.configs.base import LMCfg, MoECfg
from repro_torch.core.topk import stable_topk


class DenseFFNParams(NamedTuple):
    w_gate: torch.Tensor  # [D, F]
    w_up: torch.Tensor  # [D, F]
    w_down: torch.Tensor  # [F, D]


class MoEParams(NamedTuple):
    router: torch.Tensor  # [D, E]
    w_gate: torch.Tensor  # [E, D, Fe]
    w_up: torch.Tensor  # [E, D, Fe]
    w_down: torch.Tensor  # [E, Fe, D]
    shared: Optional[DenseFFNParams]  # always-on shared expert(s), fused into one


def init_dense_ffn(d: int, f: int, generator=None, dtype=torch.float32, device=None) -> DenseFFNParams:
    kw = dict(generator=generator, dtype=dtype, device=device)
    return DenseFFNParams(nn.dense_init(d, f, **kw), nn.dense_init(d, f, **kw), nn.dense_init(f, d, **kw))


def init_moe(cfg: LMCfg, generator=None, dtype=torch.float32, device=None) -> MoEParams:
    moe: MoECfg = cfg.moe
    d, fe, e = cfg.d_model, moe.d_ff_expert, moe.n_experts
    kw = dict(generator=generator, dtype=dtype, device=device)
    router = nn.dense_init(d, e, **kw)
    w_gate = nn._trunc_normal((e, d, fe), d**-0.5, **kw)
    w_up = nn._trunc_normal((e, d, fe), d**-0.5, **kw)
    w_down = nn._trunc_normal((e, fe, d), fe**-0.5, **kw)
    shared = init_dense_ffn(d, fe * moe.n_shared, **kw) if moe.n_shared else None
    return MoEParams(router=router, w_gate=w_gate, w_up=w_up, w_down=w_down, shared=shared)


def dense_ffn(p: DenseFFNParams, x: torch.Tensor) -> torch.Tensor:
    return nn.swiglu(x @ p.w_gate, x @ p.w_up) @ p.w_down


MOE_GROUP_TOKENS = 4096  # GShard token-group size: capacity (and the dispatch
# one-hot) is per group, so long sequences don't inflate the [.., E, C] tensors


def moe_ffn(p: MoEParams, cfg: MoECfg, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar). GShard top-k capacity dispatch."""
    b0, s0, d0 = x.shape
    if s0 > MOE_GROUP_TOKENS and s0 % MOE_GROUP_TOKENS == 0:
        ng = s0 // MOE_GROUP_TOKENS
        y, aux = moe_ffn(p, cfg, x.reshape(b0 * ng, MOE_GROUP_TOKENS, d0))
        return y.reshape(b0, s0, d0), aux
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(s * k * cfg.capacity_factor / e))

    logits = x @ p.router  # [B, S, E]
    probs = torch.softmax(logits.float(), dim=-1)

    # top-k gates, renormalized; equal probabilities go to the lower expert,
    # as lax.top_k orders them (torch.topk promises no order among ties)
    gate_vals, gate_idx = stable_topk(probs, k)  # [B, S, k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    # capacity assignment: position of each (token, choice) within its expert's queue
    onehot = F.one_hot(gate_idx, e).float()  # [B, S, k, E]
    flat = onehot.reshape(b, s * k, e)
    pos = torch.cumsum(flat, dim=1) - flat  # tokens ahead of me in this expert
    pos = pos.reshape(b, s, k, e)
    within = (pos < cap) * onehot  # [B, S, k, E] keep-mask
    pos_idx = torch.einsum("bske,bske->bsk", pos, onehot)  # queue slot per choice
    # jax.nn.one_hot gives an all-zero row for a slot at or past cap, where
    # F.one_hot would raise: a comparison with arange gives the same rows
    cap_oh = (pos_idx.long()[..., None] == torch.arange(cap, device=x.device)).float()  # [B, S, k, C]

    # the dispatch/combine products run in the activation dtype; the gates stay
    # float32 until the combine weights are cast
    dispatch = torch.einsum("bske,bskc->bsec", within, cap_oh).to(x.dtype)  # 0/1
    combine = torch.einsum("bsk,bske,bskc->bsec", gate_vals, within, cap_oh).to(x.dtype)

    xe = torch.einsum("bsec,bsd->ebcd", dispatch, x)  # [E, B, C, D]
    h = torch.einsum("ebcd,edf->ebcf", xe, p.w_gate)
    u = torch.einsum("ebcd,edf->ebcf", xe, p.w_up)
    act = F.silu(h) * u
    ye = torch.einsum("ebcf,efd->ebcd", act, p.w_down)  # [E, B, C, D]
    y = torch.einsum("bsec,ebcd->bsd", combine, ye)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))  # [E] mean router prob
    ce = onehot[:, :, 0, :].mean(dim=(0, 1))  # [E] top-1 assignment fraction
    aux = e * torch.sum(me * ce)

    if p.shared is not None:
        y = y + dense_ffn(p.shared, x)
    return y.to(x.dtype), aux

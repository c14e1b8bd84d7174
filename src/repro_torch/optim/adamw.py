"""AdamW with decoupled weight decay, global-norm clipping, warmup-cosine schedule.

The JAX package's update, operation for operation: global-norm clipping over all
gradients in float32, the schedule at ``step + 1``, bias corrections, and the
decay ``lr·wd·p`` taken on the old ``p`` beside the Adam step (not
``torch.optim.AdamW``'s ``p·(1 − lr·wd)`` first, which rounds in another order).
The port updates the parameters and moments in place, to hold one copy of each;
a leaf whose gradient is ``None`` (a non-float leaf) passes through.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.common.tree_utils import global_norm, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 0-d
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1

    def init(self, params: Any) -> AdamWState:
        zeros = lambda p: tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), p)
        device = tree_leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device), zeros(params), zeros(params))

    def schedule(self, step) -> torch.Tensor:
        s = torch.as_tensor(step).float()
        warm = s / max(self.warmup_steps, 1)
        prog = torch.clamp((s - self.warmup_steps) / max(self.total_steps - self.warmup_steps, 1), 0.0, 1.0)
        cos = self.min_lr_ratio + (1 - self.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return self.lr * torch.where(s < self.warmup_steps, warm, cos)

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any) -> tuple[Any, AdamWState, dict]:
        """Apply one step to ``params`` (in place) from float32 ``grads``;
        returns (params, the new state, {"grad_norm", "lr"})."""
        gnorm = global_norm(grads)  # a None leaf holds no gradient
        scale = torch.clamp_max(self.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)

        step = state.step + 1
        lr = self.schedule(step)
        b1c = 1 - self.b1 ** step.float()
        b2c = 1 - self.b2 ** step.float()

        def upd(p, g, m_, v_):
            if g is None:
                return
            g = g.float() * scale
            m_.copy_(self.b1 * m_ + (1 - self.b1) * g)
            v_.copy_(self.b2 * v_ + (1 - self.b2) * g * g)
            step_ = lr * (m_ / b1c) / (torch.sqrt(v_ / b2c) + self.eps)
            decay = lr * self.weight_decay * p.float()
            p.copy_((p.float() - step_ - decay).to(p.dtype))

        tree_map(upd, params, grads, state.m, state.v)
        return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}

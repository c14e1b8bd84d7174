"""Adafactor (Shazeer & Stern) with factored second moments: the memory-lean
optimizer of the decoder-only LMs (a leaf's state is a row and a column
moment instead of a full one).

The JAX package's update, operation for operation: ``beta`` from the step in
float32; a leaf of two or more dimensions factors over its last two axes
(the stacked ``[n_groups, in, out]`` leaves too), any other keeps a full
moment and an empty ``(0,)`` column moment; the update's RMS and the
parameter scale are taken over the whole leaf. The port updates the float32
master weights and the moments in place, as its ``AdamW`` does, to hold one
copy of each; a leaf whose gradient is ``None`` (a non-float leaf) passes
through.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.common.tree_utils import tree_leaves, tree_map


class FactoredMoment(NamedTuple):
    vr: torch.Tensor  # row second moment (or the full moment of a leaf under 2-D)
    vc: torch.Tensor  # column second moment (empty under 2-D)


class AdafactorState(NamedTuple):
    step: torch.Tensor  # int32 0-d
    moments: Any


@dataclass(frozen=True)
class Adafactor:
    lr: float = 1e-3
    decay: float = 0.8
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0

    def init(self, params: Any) -> AdafactorState:
        def mk(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return FactoredMoment(torch.zeros(p.shape[:-1], **f32), torch.zeros(p.shape[:-2] + p.shape[-1:], **f32))
            return FactoredMoment(torch.zeros(p.shape, **f32), torch.zeros((0,), **f32))

        device = tree_leaves(params)[0].device
        return AdafactorState(torch.zeros((), dtype=torch.int32, device=device), tree_map(mk, params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdafactorState, params: Any) -> tuple[Any, AdafactorState, dict]:
        """Apply one step to ``params`` (in place) from float32 ``grads``;
        returns (params, the new state, {})."""
        step = state.step + 1
        beta = 1.0 - (step.float() + 1) ** (-self.decay)

        def upd(p, g, mom: FactoredMoment):
            if g is None:
                return
            g = g.float()
            g2 = g * g
            g2.add_(self.eps1)
            if p.ndim >= 2:
                mom.vr.copy_(beta * mom.vr + (1 - beta) * g2.mean(dim=-1))
                mom.vc.copy_(beta * mom.vc + (1 - beta) * g2.mean(dim=-2))
                del g2
                row = mom.vr / torch.clamp_min(mom.vr.mean(dim=-1, keepdim=True), self.eps1)
                u = row[..., None] * mom.vc[..., None, :]  # the denominator, then the update in its memory
            else:
                mom.vr.copy_(beta * mom.vr + (1 - beta) * g2)
                del g2
                u = mom.vr.clone()
            u.add_(self.eps1).rsqrt_()
            u = torch.mul(g, u, out=u)
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + self.eps1)
            u.div_(torch.clamp_min(rms_u / self.clip_threshold, 1.0))
            pf = p.float()
            scale = torch.clamp_min(torch.sqrt(torch.mean(torch.square(pf))), self.eps2)
            u.mul_(self.lr * scale)
            if p.dtype == torch.float32:
                p.sub_(u)
            else:
                p.copy_((pf - u).to(p.dtype))

        tree_map(upd, params, grads, state.moments)
        return params, AdafactorState(step, state.moments), {}

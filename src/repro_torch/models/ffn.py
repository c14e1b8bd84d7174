"""The dense SwiGLU feed-forward layer.

The JAX package's capacity-dispatched MoE (``init_moe``, ``moe_ffn``) is not
ported yet (ROADMAP queue 1 item 6); ``require_dense`` refuses a config that
asks for it, so no MoE config silently runs a dense path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common import module as nn
from repro_torch.configs.base import LMCfg


class DenseFFNParams(NamedTuple):
    w_gate: torch.Tensor  # [D, F]
    w_up: torch.Tensor  # [D, F]
    w_down: torch.Tensor  # [F, D]


def require_dense(cfg: LMCfg) -> None:
    if cfg.moe is not None:
        raise NotImplementedError("MoE feed-forward layers are not ported yet: ROADMAP queue 1 item 6")


def init_dense_ffn(d: int, f: int, generator=None, dtype=torch.float32, device=None) -> DenseFFNParams:
    kw = dict(generator=generator, dtype=dtype, device=device)
    return DenseFFNParams(nn.dense_init(d, f, **kw), nn.dense_init(d, f, **kw), nn.dense_init(f, d, **kw))


def dense_ffn(p: DenseFFNParams, x: torch.Tensor) -> torch.Tensor:
    return nn.swiglu(x @ p.w_gate, x @ p.w_up) @ p.w_down

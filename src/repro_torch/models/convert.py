"""Carry a model's weights across between the JAX package and the port.

``from_arrays`` takes the JAX package's ``LMParams`` with its leaves as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``) and gives the port's
``LMParams`` of tensors; ``SparseEncoder(cfg, from_arrays(p, device))`` is the
module. ``to_arrays`` goes back, to the port's NamedTuples with numpy leaves,
field for field what the JAX package's classes hold.

This is the one place that handles weight orientation. Both packages keep a
dense weight as ``[in, out]`` and compute ``x @ w`` (no ``nn.Linear``, whose
``[out, in]`` weight would be transposed here), so leaves cross unchanged and
to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree_utils import tree_map
from repro_torch.device import resolve_device
from repro_torch.models.attention import AttnParams
from repro_torch.models.ffn import DenseFFNParams
from repro_torch.models.transformer import LayerParams, LMParams


def from_arrays(p, device=None) -> LMParams:
    """The JAX package's ``LMParams`` (numpy leaves) as the port's, on ``device``
    (CUDA by default). Fields are read by name."""
    device = resolve_device(device)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a, copy=True)).to(device)

    def fields(src, cls):
        return cls(*(t(getattr(src, f)) for f in cls._fields))

    layers = tuple(
        LayerParams(attn=fields(lp.attn, AttnParams), ffn=fields(lp.ffn, DenseFFNParams),
                    norm1=t(lp.norm1), norm2=t(lp.norm2))
        for lp in p.layers
    )
    return LMParams(embed=t(p.embed), layers=layers, final_norm=t(p.final_norm), lm_head=t(p.lm_head))


def to_arrays(params: LMParams) -> LMParams:
    """The port's parameters as host numpy copies, in the same NamedTuples."""
    return tree_map(lambda x: x.detach().cpu().numpy().copy(), params)

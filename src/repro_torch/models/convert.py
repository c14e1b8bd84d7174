"""Carry a model's weights across between the JAX package and the port.

``from_arrays`` takes the JAX package's ``LMParams`` or ``StackedLMParams``,
or a recsys or SchNet tree (``DLRMParams``, ``DINParams``, ``MINDParams``,
``EmbedTables``, ``SchNetParams``, ``InteractionParams``), with its leaves as
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and gives the
port's tree of tensors in the same layout, dense or MoE feed-forwards, tied
or untied head, the MLPs as tuples, the tables' offsets int32;
``SparseEncoder(cfg, from_arrays(p, device))`` is the encoder module.
``to_arrays`` goes back, to the port's NamedTuples with numpy leaves, field
for field what the JAX package's classes hold.

This is the one place that handles weight orientation. Both packages keep a
dense weight as ``[in, out]`` (an expert's as ``[E, in, out]``) and compute
``x @ w`` (no ``nn.Linear``, whose ``[out, in]`` weight would be transposed
here), so leaves cross unchanged and to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree_utils import tree_map
from repro_torch.device import resolve_device
from repro_torch.models.attention import AttnParams
from repro_torch.models.ffn import DenseFFNParams, MoEParams
from repro_torch.models.recsys import DINParams, DLRMParams, EmbedTables, MINDParams
from repro_torch.models.schnet import InteractionParams, SchNetParams
from repro_torch.models.stacked import StackedLMParams
from repro_torch.models.transformer import LayerParams, LMParams

# the JAX package's parameter classes, by name, and the port's of the same fields
_CLASSES = {cls.__name__: cls for cls in (LMParams, StackedLMParams, LayerParams, AttnParams, DenseFFNParams,
                                          MoEParams, EmbedTables, DLRMParams, DINParams, MINDParams,
                                          InteractionParams, SchNetParams)}


def from_arrays(p, device=None):
    """A JAX parameter tree (numpy leaves) as the port's, on ``device`` (CUDA
    by default). Fields are read by name."""
    device = resolve_device(device)

    def conv(node):
        if node is None:
            return None
        cls = _CLASSES.get(type(node).__name__)
        if cls is not None:
            return cls(*(conv(getattr(node, f)) for f in cls._fields))
        if isinstance(node, (tuple, list)):  # the layers, the positions of a group, an MLP
            return tuple(conv(v) for v in node)
        return torch.from_numpy(np.array(node, copy=True)).to(device)

    return conv(p)


def to_arrays(params):
    """The port's parameters as host numpy copies, in the same NamedTuples."""
    return tree_map(lambda x: x.detach().cpu().numpy().copy(), params)

"""schnet [gnn] — n_interactions=3 d_hidden=64 rbf=300 cutoff=10.
Continuous-filter convolution over radial-basis edge features; message passing
implemented with jax.ops.segment_sum over an edge index (see repro/models/schnet.py).
[arXiv:1706.08566; paper]
"""

from repro_torch.configs.base import ArchConfig, GNNCfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="schnet",
        family="gnn",
        gnn=GNNCfg(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0),
    )
)

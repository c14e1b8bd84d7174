"""dlrm-rm2 [recsys] — n_dense=13 n_sparse=26 embed_dim=64 bot_mlp=13-512-256-64
top_mlp=512-512-256-1 interaction=dot. RM2-class model from the DLRM paper; per-table
cardinalities are not published for RM2 so we use uniform 1M-row tables (noted).
[arXiv:1906.00091; paper]
"""

from repro_torch.configs.base import ArchConfig, RecsysCfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="dlrm-rm2",
        family="recsys",
        recsys=RecsysCfg(
            n_dense=13,
            n_sparse=26,
            embed_dim=64,
            bot_mlp=(512, 256, 64),
            top_mlp=(512, 512, 256, 1),
            interaction="dot",
            vocab_sizes=(1_000_000,) * 26,
        ),
        notes="RM2 per-table cardinalities unpublished; uniform 1M rows/table.",
    )
)

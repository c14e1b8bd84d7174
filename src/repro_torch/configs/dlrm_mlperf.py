"""dlrm-mlperf [recsys] — MLPerf DLRM benchmark config (Criteo 1TB):
n_dense=13 n_sparse=26 embed_dim=128 bot_mlp=13-512-256-128
top_mlp=1024-1024-512-256-1 interaction=dot.
Per-table vocab sizes are the published Criteo-1TB categorical cardinalities used by
the MLPerf reference implementation. [arXiv:1906.00091; paper]
"""

from repro_torch.configs.base import ArchConfig, RecsysCfg, register_arch

# MLPerf DLRM (Criteo Terabyte, day-based split) categorical feature cardinalities.
CRITEO_1TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

CONFIG = register_arch(
    ArchConfig(
        name="dlrm-mlperf",
        family="recsys",
        recsys=RecsysCfg(
            n_dense=13,
            n_sparse=26,
            embed_dim=128,
            bot_mlp=(512, 256, 128),
            top_mlp=(1024, 1024, 512, 256, 1),
            interaction="dot",
            vocab_sizes=CRITEO_1TB_VOCABS,
        ),
        notes="~24B embedding rows x 128 dims = 11.2 TB fp32; requires row-sharded "
        "tables over the model axis (see repro/distributed/sharding.py).",
    )
)

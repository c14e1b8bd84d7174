"""din [recsys] — embed_dim=18 hist seq_len=100 attn_mlp=80-40 mlp=200-80,
interaction=target-attention. Fields follow the DIN paper's Alibaba setup
(goods_id / shop_id / cate_id); vocab sizes are the public Taobao-scale counts.
[arXiv:1706.06978; paper]
"""

from repro_torch.configs.base import ArchConfig, RecsysCfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="din",
        family="recsys",
        recsys=RecsysCfg(
            n_dense=0,
            n_sparse=3,  # goods_id, shop_id, cate_id (target item; history carries same 3)
            embed_dim=18,
            bot_mlp=(),
            top_mlp=(200, 80, 1),
            interaction="target_attn",
            vocab_sizes=(10_000_000, 1_000_000, 10_000),
            hist_len=100,
            attn_mlp=(80, 40),
        ),
    )
)

"""mind [recsys] — embed_dim=64 n_interests=4 capsule_iters=3,
interaction=multi-interest (dynamic-routing capsules over user behavior sequence;
serving scores candidates by max over interest vectors).
[arXiv:1904.08030; unverified]
"""

from repro_torch.configs.base import ArchConfig, RecsysCfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="mind",
        family="recsys",
        recsys=RecsysCfg(
            n_dense=0,
            n_sparse=2,  # item_id, cate_id
            embed_dim=64,
            bot_mlp=(),
            top_mlp=(256, 64),  # label-aware projection dims (output = embed space)
            interaction="multi_interest",
            vocab_sizes=(10_000_000, 100_000),
            hist_len=50,
            n_interests=4,
            capsule_iters=3,
        ),
    )
)

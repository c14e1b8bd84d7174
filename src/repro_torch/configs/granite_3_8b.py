"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800, vocab=49155.
[hf:ibm-granite/granite-3.0-*; hf]
"""

from repro_torch.configs.base import ArchConfig, LMCfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="granite-3-8b",
        family="lm",
        lm=LMCfg(
            n_layers=40,
            d_model=4096,
            n_heads=32,
            n_kv_heads=8,
            d_ff=12800,
            vocab=49155,
            head_dim=128,
            attn_pattern="full",
            rope_theta=10000.0,
            tie_embeddings=True,
        ),
        skip_shapes={
            "long_500k": "pure full-attention arch; long_500k requires sub-quadratic "
            "attention per pool instruction (see DESIGN.md §6)"
        },
    )
)

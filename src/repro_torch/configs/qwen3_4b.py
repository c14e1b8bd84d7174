"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728, vocab=151936,
qk_norm. head_dim=128 (decoupled from d_model/n_heads, as in Qwen3).
[hf:Qwen/Qwen3-*; hf]
"""

from repro_torch.configs.base import ArchConfig, LMCfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="qwen3-4b",
        family="lm",
        lm=LMCfg(
            n_layers=36,
            d_model=2560,
            n_heads=32,
            n_kv_heads=8,
            d_ff=9728,
            vocab=151936,
            head_dim=128,
            qk_norm=True,
            attn_pattern="full",
            rope_theta=1000000.0,
            tie_embeddings=True,
        ),
        skip_shapes={
            "long_500k": "pure full-attention arch; long_500k requires sub-quadratic "
            "attention per pool instruction (see DESIGN.md §6)"
        },
    )
)

"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504, vocab=262144.
5:1 sliding-window(1024):global hybrid attention, 128k context.
[hf:google/gemma-3-*; unverified]
"""

from repro_torch.configs.base import ArchConfig, LMCfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="gemma3-27b",
        family="lm",
        lm=LMCfg(
            n_layers=62,
            d_model=5376,
            n_heads=32,
            n_kv_heads=16,
            d_ff=21504,
            vocab=262144,
            head_dim=128,
            attn_pattern="hybrid_swa",
            window=1024,
            local_ratio=5,
            qk_norm=True,
            rope_theta=1000000.0,
            tie_embeddings=True,
        ),
        notes="hybrid SWA makes long_500k runnable: local layers cache only `window` KVs.",
    )
)

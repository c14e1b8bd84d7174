"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192,
vocab=202048, MoE 128 experts top-1 (+1 shared expert, early-fusion family).
iRoPE hybrid attention: 3 chunked-local (8k chunks, RoPE) : 1 global (NoPE) layers.
[hf:meta-llama/Llama-4-*; unverified]
"""

from repro_torch.configs.base import ArchConfig, LMCfg, MoECfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="llama4-maverick-400b-a17b",
        family="lm",
        lm=LMCfg(
            n_layers=48,
            d_model=5120,
            n_heads=40,
            n_kv_heads=8,
            d_ff=8192,
            vocab=202048,
            head_dim=128,
            moe=MoECfg(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1, every_n=2),
            attn_pattern="hybrid_chunked",
            window=8192,
            local_ratio=3,
            rope_theta=500000.0,
        ),
        notes=(
            "MoE top-1 with shared expert; hybrid chunked-local attention makes "
            "long_500k runnable (local layers cache only the last chunk)."
        ),
    )
)

"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400,
vocab=32064, MoE 16 experts top-2. Pure full attention.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

from repro_torch.configs.base import ArchConfig, LMCfg, MoECfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="lm",
        lm=LMCfg(
            n_layers=32,
            d_model=4096,
            n_heads=32,
            n_kv_heads=8,
            d_ff=6400,
            vocab=32064,
            head_dim=128,
            moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=6400),
            attn_pattern="full",
            rope_theta=10000.0,
        ),
        skip_shapes={
            "long_500k": "pure full-attention arch; long_500k requires sub-quadratic "
            "attention per pool instruction (see DESIGN.md §6)"
        },
    )
)

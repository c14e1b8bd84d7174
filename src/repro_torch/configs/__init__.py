"""Arch config registration. Importing this package registers all assigned archs."""

from repro_torch.configs.base import (
    ARCHS,
    ArchConfig,
    GNNCfg,
    LMCfg,
    MoECfg,
    RecsysCfg,
    ShapeSpec,
    all_arch_names,
    get_arch,
)

# one module per assigned architecture (+ the paper's own retrieval config)
from repro_torch.configs import (  # noqa: F401
    llama4_maverick,
    phi35_moe,
    gemma3_27b,
    granite_3_8b,
    qwen3_4b,
    schnet,
    din,
    dlrm_mlperf,
    dlrm_rm2,
    mind,
    lsp_msmarco,
)

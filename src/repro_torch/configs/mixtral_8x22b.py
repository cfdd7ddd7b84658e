"""mixtral-8x22b [moe] — 8 experts top-2, SWA. [arXiv:2401.04088]

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    source="arXiv:2401.04088",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    block_pattern=("swa",),
    sliding_window=4096,
    dp_mode="fsdp",
    lbgm=LBGMConfig(variant="topk", k_frac=0.01, num_clients=16),
    long_context="swa",
)

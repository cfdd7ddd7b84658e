"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.
Dense per-client LBG is infeasible at this scale => topk LBG.
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(num_experts=128, top_k=1, capacity_factor=1.25),
    block_pattern=("attn",),
    sliding_window=8192,
    dp_mode="fsdp",
    lbgm=LBGMConfig(variant="topk", k_frac=0.005, num_clients=16),
    long_context="swa",
)

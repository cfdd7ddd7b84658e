"""mistral-large-123b [dense]. [hf:mistralai/Mistral-Large-Instruct-2407]

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    arch_type="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    block_pattern=("attn",),
    sliding_window=8192,
    dp_mode="fsdp",
    lbgm=LBGMConfig(variant="topk", k_frac=0.01, num_clients=16),
    long_context="swa",
)

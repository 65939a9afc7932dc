"""Llama-3.2-3B dense decoder: 28L, d=3072, 24 heads (GQA kv=8), d_ff=8192,
vocab=128256. [hf:meta-llama/Llama-3.2-1B family]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3_2_3b", arch_type="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=128,
    block_type="dense", act="silu", gated_mlp=True, rope_theta=5e5,
    norm="rmsnorm",
    source="hf:meta-llama/Llama-3.2-1B",
)

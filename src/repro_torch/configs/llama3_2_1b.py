"""Llama-3.2-1B dense decoder: 16L, d=2048, 32 heads (GQA kv=8), d_ff=8192,
vocab=128256. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3_2_1b", arch_type="dense", n_layers=16, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=64,
    block_type="dense", act="silu", gated_mlp=True, rope_theta=5e5,
    norm="rmsnorm",
    source="hf:meta-llama/Llama-3.2-1B",
)

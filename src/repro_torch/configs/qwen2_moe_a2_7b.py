"""Qwen2-MoE-A2.7B: 24L, d=2048, 16 heads (MHA kv=16), expert d_ff=1408,
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_moe_a2_7b", arch_type="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=151936, head_dim=128,
    block_type="moe", act="silu", gated_mlp=True,
    n_experts=60, top_k=4, n_shared_experts=4, rope_theta=1e6,
    norm="rmsnorm",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

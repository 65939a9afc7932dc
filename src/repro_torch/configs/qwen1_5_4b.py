"""Qwen1.5-4B-class dense decoder: 40L, d=2560, 20 heads (MHA: kv=20),
d_ff=6912, vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B family]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1_5_4b", arch_type="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, d_ff=6912, vocab=151936, head_dim=128,
    block_type="dense", act="silu", gated_mlp=True, qkv_bias=True,
    rope_theta=1e6, norm="rmsnorm",
    source="hf:Qwen/Qwen1.5-0.5B",
)

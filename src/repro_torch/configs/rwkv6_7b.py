"""RWKV-6 "Finch" 7B: 32L, d=4096, attention-free (64 wkv heads of 64),
d_ff=14336, vocab=65536, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6_7b", arch_type="ssm", n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64, d_ff=14336, vocab=65536, head_dim=64,
    block_type="rwkv", norm="layernorm",
    source="arXiv:2404.05892",
)

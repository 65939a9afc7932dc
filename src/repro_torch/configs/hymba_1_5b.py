"""Hymba-1.5B hybrid: 32L, d=1600, 25 heads (GQA kv=5), d_ff=5504,
vocab=32001, parallel attention + mamba heads, ssm_state=16.
[arXiv:2411.13676]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba_1_5b", arch_type="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001, head_dim=64,
    block_type="hymba", act="silu", gated_mlp=True,
    ssm_state=16, ssm_expand=2, norm="rmsnorm",
    source="arXiv:2411.13676",
)

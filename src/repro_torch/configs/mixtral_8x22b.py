"""Mixtral-8x22B MoE: 56L, d=6144, 48 heads (GQA kv=8), expert d_ff=16384,
vocab=32768, 8 experts top-2, sliding-window attention. [arXiv:2401.04088]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral_8x22b", arch_type="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768, head_dim=128,
    block_type="moe", act="silu", gated_mlp=True,
    n_experts=8, top_k=2, sliding_window=4096, rope_theta=1e6,
    norm="rmsnorm", kfac_max_dim=4096,
    source="arXiv:2401.04088",
)

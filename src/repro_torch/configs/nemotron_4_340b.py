"""Nemotron-4-340B dense decoder: 96L, d=18432, 96 heads (GQA kv=8),
d_ff=73728, vocab=256000, squared-ReLU MLP (ungated). [arXiv:2402.16819]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron_4_340b", arch_type="dense", n_layers=96, d_model=18432,
    n_heads=96, n_kv_heads=8, d_ff=73728, vocab=256000, head_dim=192,
    block_type="dense", act="relu2", gated_mlp=False, rope_theta=1e4,
    norm="layernorm", kfac_max_dim=4096,
    source="arXiv:2402.16819",
)

"""LLaVA-NeXT-34B VLM backbone: 60L, d=7168, 56 heads (GQA kv=8),
d_ff=20480, vocab=64000. AnyRes tiling: the ViT/SigLIP vision tower +
anyres tiler is the stubbed frontend — the batch supplies precomputed
patch embeddings, ``pixel_embeds`` (2880 tokens = 5 tiles x 576 patches,
dim 1152), which the in-model projector maps to d_model. [hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava_next_34b", arch_type="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000, head_dim=128,
    block_type="dense", act="silu", gated_mlp=True, rope_theta=5e6,
    norm="rmsnorm", kfac_max_dim=4096,
    frontend="vision", frontend_tokens=2880, frontend_dim=1152,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

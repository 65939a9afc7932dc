"""MusicGen-medium audio decoder backbone: 48L, d=1536, 24 heads (MHA),
d_ff=6144, vocab=2048 (EnCodec codebook). Decoder-only over EnCodec tokens;
the EnCodec tokenizer itself is the stubbed frontend — the model takes the
token ids directly (the codebook-delay interleave is upstream of the
backbone). GELU, LayerNorm. [arXiv:2306.05284]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen_medium", arch_type="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048, head_dim=64,
    block_type="dense", act="gelu", gated_mlp=False, norm="layernorm",
    frontend="audio",
    source="arXiv:2306.05284",
)

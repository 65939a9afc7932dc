"""Architecture configuration schema + registry (counterpart of
``repro/configs/base.py``), with ``dtype`` as a torch dtype.

Every family of the JAX package is registered: the dense decoders
``llama3_2_1b``, ``llama3_2_3b``, ``qwen1_5_4b``, ``musicgen_medium``
(audio: EnCodec token ids in, no frontend code), ``nemotron_4_340b`` and
``llava_next_34b`` (a VLM: the ``proj`` site maps precomputed patch
embeddings to ``d_model``); the MoE decoders ``mixtral_8x22b`` (8
experts, top-2, sliding window 4096) and ``qwen2_moe_a2_7b`` (60 routed
experts, top-4, 4 shared); the recurrent ``rwkv6_7b`` (RWKV-6 time and
channel mix, attention-free) and ``hymba_1_5b`` (attention and a selective
SSM in parallel in every block); each an :class:`ArchConfig` with the
fields those blocks, their frontend, the SP-NGD training step and its fp8
factor capture read (the JAX package's tensor-parallel alignment fields
have no meaning on one device and are not taken); and ``resnet50`` (a
``repro_torch.models.resnet.ConvNetConfig``)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

BACKENDS = ("ref", "cuda", "auto")


def check_backend(backend: str | None) -> None:
    """Refuse backend names the port does not have (``"pallas"`` is the JAX
    package's TPU route; here the kernel route is ``"cuda"``)."""
    if backend is None or backend in BACKENDS:
        return
    if backend == "pallas":
        raise ValueError("backend 'pallas' is the JAX package's TPU route; "
                         "repro_torch takes 'ref' | 'cuda' | 'auto'")
    raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    block_type: str = "dense"    # dense | moe | hymba | rwkv
    act: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    rope_theta: float = 5e5
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    # MoE
    n_experts: int = 0           # routed experts
    n_shared_experts: int = 0    # always-on experts, one gated MLP of
                                 # n_shared_experts * d_ff
    top_k: int = 0               # experts a token is routed to
    capacity_factor: float = 1.25  # expert buffer: cf * tokens * top_k / E
    # SSM / hybrid
    ssm_state: int = 0           # selective-SSM state size N (hymba)
    ssm_expand: int = 2          # SSM inner width d_inner = expand * d_model
    # attention
    sliding_window: int = 0      # 0 = full causal
    # frontend stubs (vlm / audio)
    frontend: str = "none"       # none | vision | audio
    frontend_tokens: int = 0     # patches / frames prepended
    frontend_dim: int = 0        # raw embedding dim before projector
    aux_loss_coef: float = 0.01  # weight of the blocks' auxiliary loss
    # kernels
    backend: str = "auto"        # "ref" | "cuda" | "auto" (kernels.dispatch)
    # K-FAC
    kfac_max_dim: int = 2048     # block-diagonal factor cap
    factor_wire: str = ""        # "" = dense f32 factor capture; "e4m3" /
                                 # "e5m2" = the fused capture emits
                                 # wire-format (sym-packed fp8 payload +
                                 # per-block scale) sums for full-kind
                                 # factors (kernels.dispatch.factor_sum_wire)
    head_g_kind: str = "diag"    # vocab-side factor of the LM head
    scan_chunk: int = 0          # >0: the recurrent scans (rwkv/ssm) run in
                                 # chunks of `scan_chunk` tokens, each
                                 # recomputed in the backward
    # numerics / memory
    dtype: Any = torch.bfloat16
    remat: bool = True           # recompute each block in the backward
    # citation
    source: str = ""

    def __post_init__(self):
        check_backend(self.backend)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def validate(self) -> None:
        """Blocks with attention (dense, moe, hymba) need whole GQA groups;
        MoE blocks need experts and a top-k."""
        if self.block_type in ("dense", "moe", "hymba"):
            assert self.n_heads > 0 and self.n_heads % self.n_kv_heads == 0
        if self.block_type == "moe":
            assert self.n_experts > 0 and self.top_k > 0

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims (2 layers, d<=512,
        at most 4 experts, 1 shared, top-2, at most 8 frontend tokens of
        dim 64, an SSM state of at most 8), f32, factor blocks of at most
        128, no remat. An attention-free config keeps no heads and at most
        128 of width."""
        hd = min(self.hd, 64)
        n_heads = max(2, min(4, self.n_heads)) if self.n_heads else 0
        n_kv = max(1, min(n_heads, max(1, self.n_kv_heads * n_heads
                                       // max(self.n_heads, 1))))
        kw = dict(
            n_layers=2,
            d_model=min(self.d_model,
                        hd * max(n_heads, 2) if n_heads else 128),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 256),
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend_tokens else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            kfac_max_dim=128,
            dtype=torch.float32,
            remat=False,
        )
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCHS = ["qwen1_5_4b", "hymba_1_5b", "musicgen_medium", "llama3_2_1b",
         "mixtral_8x22b", "qwen2_moe_a2_7b", "llava_next_34b",
         "nemotron_4_340b", "rwkv6_7b", "llama3_2_3b", "resnet50"]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({"qwen1.5-4b": "qwen1_5_4b", "hymba-1.5b": "hymba_1_5b",
                 "llama3.2-1b": "llama3_2_1b", "llama3.2-3b": "llama3_2_3b",
                 "qwen2-moe-a2.7b": "qwen2_moe_a2_7b"})


def list_archs() -> list[str]:
    return list(ARCHS)


def get_config(name: str):
    """The registered config: an :class:`ArchConfig` (validated), or the
    ``ConvNetConfig`` of ``resnet50`` as it is."""
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; repro_torch has "
                       f"{ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg = mod.CONFIG
    if isinstance(cfg, ArchConfig):
        cfg.validate()
    return cfg

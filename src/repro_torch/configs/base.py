"""Architecture configuration schema + registry (counterpart of
``repro/configs/base.py``), with ``dtype`` as a torch dtype.

Only the families the ported paths run are registered: the dense
decoders ``llama3_2_1b``, ``llama3_2_3b``, ``qwen1_5_4b``,
``musicgen_medium`` (audio: EnCodec token ids in, no frontend code),
``nemotron_4_340b`` and ``llava_next_34b`` (a VLM: the ``proj`` site maps
precomputed patch embeddings to ``d_model``); the MoE decoders
``mixtral_8x22b`` (8 experts, top-2, sliding window 4096) and
``qwen2_moe_a2_7b`` (60 routed experts, top-4, 4 shared); each an
:class:`ArchConfig` with only the fields those blocks, their frontend, the
SP-NGD training step and its fp8 factor capture read (the SSM fields
arrive with the slice that reads them); and ``resnet50`` (a
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
    arch_type: str               # dense | moe | vlm | audio (the
                                 # families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    block_type: str = "dense"    # dense | moe (DecoderLM refuses the
                                 # others)
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
        """Dense and MoE blocks (every family registered here: decoders,
        the VLM backbone, the audio decoder) need whole GQA groups; MoE
        blocks need experts and a top-k."""
        assert self.n_heads > 0 and self.n_heads % self.n_kv_heads == 0
        if self.block_type == "moe":
            assert self.n_experts > 0 and self.top_k > 0

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims (2 layers, d<=512,
        at most 4 experts, 1 shared, top-2, at most 8 frontend tokens of
        dim 64), f32, factor blocks of at most 128, no remat."""
        hd = min(self.hd, 64)
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(n_heads, max(1, self.n_kv_heads * n_heads
                                       // self.n_heads)))
        kw = dict(
            n_layers=2,
            d_model=min(self.d_model, hd * n_heads),
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
            kfac_max_dim=128,
            dtype=torch.float32,
            remat=False,
        )
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


ARCHS = ["qwen1_5_4b", "musicgen_medium", "llama3_2_1b", "mixtral_8x22b",
         "qwen2_moe_a2_7b", "llava_next_34b", "nemotron_4_340b",
         "llama3_2_3b", "resnet50"]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({"qwen1.5-4b": "qwen1_5_4b", "llama3.2-1b": "llama3_2_1b",
                 "llama3.2-3b": "llama3_2_3b",
                 "qwen2-moe-a2.7b": "qwen2_moe_a2_7b"})


def list_archs() -> list[str]:
    return list(ARCHS)


def get_config(name: str):
    """The registered config: an :class:`ArchConfig` (validated), or the
    ``ConvNetConfig`` of ``resnet50`` as it is."""
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise KeyError(f"architecture {name!r} is not ported yet; "
                       f"repro_torch has {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg = mod.CONFIG
    if isinstance(cfg, ArchConfig):
        cfg.validate()
    return cfg

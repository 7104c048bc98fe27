"""Model configuration shared by every LM architecture (counterpart of
repro/models/config.py).

Two deliberate differences from the reference:

* ``attn_impl`` is ``"plain" | "kernel"`` (the reference's ``"xla" |
  "pallas"``): ``"kernel"`` sends the full-sequence forward through the
  hand-written ``flash_attention`` and ``ssd_scan`` kernels.
  :func:`repro_torch.interop.lm_config_from_fields` maps the names.
* ``pdtype`` / ``adtype`` are torch dtypes.

The fields that shape the device mesh (``batch_axes``,
``kv_cache_shard``, ``moe_groups``, ``attn_head_shard``) act as in the
reference when the model runs on DTensors (:mod:`repro_torch.launch.
mesh`); off a mesh they change nothing but ``moe_groups``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

ATTN_IMPLS = ("plain", "kernel")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0          # leading dense layers (Kimi-K2 style)
    d_ff_shared: int = 0            # shared-expert FFN width (0 = none)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128            # N
    head_dim: int = 64              # P
    num_heads: int = 0              # derived if 0: d_inner / head_dim
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma temporal-mixing pattern."""
    pattern: Tuple[str, ...] = ("rglru", "rglru", "local_attn")
    window: int = 2048
    lru_width: int = 0              # defaults to d_model


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder."""
    encoder_layers: int = 24
    encoder_seq: int = 1500         # audio frames after the conv stub
    d_frame: int = 128              # stub frontend frame feature size


@dataclass(frozen=True)
class VLMConfig:
    """InternVL-style stub vision frontend."""
    num_patches: int = 256
    d_patch: int = 1024             # stub ViT feature size


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense|moe|vlm|hybrid|audio|ssm
    num_layers: int = 4
    d_model: int = 512
    num_heads: int = 8
    kv_heads: int = 8
    head_dim: int = 0               # derived d_model // num_heads if 0
    d_ff: int = 2048
    vocab_size: int = 32000
    max_seq: int = 4096
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    activation: str = "swiglu"      # swiglu|gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    #: activation checkpointing policy (none|full|dots|dots_no_batch),
    #: applied where autograd records (``models.stacking.remat_wrap``)
    remat: str = "none"
    attn_impl: str = "plain"        # plain | kernel
    #: mesh axes of the batch dim
    batch_axes: tuple = ("data",)
    #: chunk size for memory-efficient attention (0 = never chunk)
    attn_chunk: int = 2048
    #: keep attention scores in f32 (False keeps them in the act. dtype)
    attn_scores_f32: bool = True
    #: GQA K/V expansion: "repeat" | "grouped"
    gqa_mode: str = "repeat"
    #: head-wise re-shard before attention (on a mesh)
    attn_head_shard: bool = False
    #: KV-cache sharding layout ("seq": the sequence on model)
    kv_cache_shard: str = "seq"
    #: MoE dispatch groups
    moe_groups: int = 16
    #: vocab-chunked cross entropy: tokens per chunk
    ce_seq_chunk: int = 1024
    #: attention family: "full" is O(S^2)
    sub_quadratic: bool = False

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{self.attn_impl!r}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 256 (the reference's embedding layout); the
        rows past ``vocab_size`` stay, and greedy decoding takes its
        argmax over them too, as the reference does."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.activation_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""
    name: str                        # train_4k | prefill_32k | ...
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode
    microbatch: int = 0              # grad-accum microbatch (0 = off)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

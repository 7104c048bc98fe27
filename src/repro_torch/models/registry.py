"""Model registry: family -> model class (counterpart of
repro/models/registry.py)."""
from __future__ import annotations

from ..device import DeviceLike
from .config import ModelConfig
from .mamba2 import Mamba2LM
from .recurrentgemma import RecurrentGemmaLM
from .transformer import TransformerLM
from .whisper import WhisperEncDec

ARCH_FAMILIES = {
    "dense": TransformerLM,
    "moe": TransformerLM,
    "vlm": TransformerLM,
    "hybrid": RecurrentGemmaLM,
    "audio": WhisperEncDec,
    "ssm": Mamba2LM,
}


def build_model(cfg: ModelConfig, device: DeviceLike = None):
    """The model of ``cfg.family`` on ``device`` (``None`` means CUDA),
    its parameters allocated but not drawn: call ``init_params`` or
    load a state."""
    try:
        cls = ARCH_FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r}") from None
    return cls(cfg, device)

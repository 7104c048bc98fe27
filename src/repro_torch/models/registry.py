"""Model registry: family -> model class (counterpart of
repro/models/registry.py). Ported: ``dense`` and ``ssm``; the other
families of the reference raise ``NotImplementedError`` naming the slice
that ports them."""
from __future__ import annotations

from ..device import DeviceLike
from .config import ModelConfig
from .mamba2 import Mamba2LM
from .transformer import TransformerLM

ARCH_FAMILIES = {
    "dense": TransformerLM,
    "ssm": Mamba2LM,
}

#: the reference's other families and the model each needs
LATER_FAMILIES = {
    "moe": "MoE TransformerLM",
    "vlm": "VLM TransformerLM",
    "hybrid": "RecurrentGemmaLM",
    "audio": "WhisperEncDec",
}


def build_model(cfg: ModelConfig, device: DeviceLike = None):
    """The model of ``cfg.family`` on ``device`` (``None`` means CUDA),
    its parameters allocated but not drawn: call ``init_params`` or
    load a state."""
    if cfg.family in LATER_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({LATER_FAMILIES[cfg.family]}) "
            f"is not ported yet: it comes with the remaining-models slice")
    try:
        cls = ARCH_FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r}") from None
    return cls(cfg, device)

"""Configs of the port (counterpart of repro/configs).

Each module defines ``FULL`` (the published configuration) and
``smoke()`` (a reduced same-family configuration for CPU tests), field
for field the reference's. ``get_config(name)`` / ``get_smoke(name)`` /
``list_archs()`` are the public API, as in the reference: the ten LM
archs and the paper's own artifact (:mod:`cgra_amber`).
``input_specs`` builds the stand-ins of a cell's inputs for the dry run
(:mod:`repro_torch.launch.dryrun`): empty tensors, fake ones when it is
called under a ``FakeTensorMode``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from ..models.config import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_ARCHS = [
    "tinyllama_1_1b",
    "phi3_mini_3_8b",
    "deepseek_coder_33b",
    "qwen3_14b",
    "kimi_k2_1t_a32b",
    "granite_moe_3b_a800m",
    "internvl2_2b",
    "recurrentgemma_2b",
    "whisper_medium",
    "mamba2_1_3b",
    "cgra_amber",            # the paper's own CGRA config (Canal side)
]

ALIASES = {name.replace("_", "-"): name for name in _ARCHS}


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {_ARCHS}")
    return name


def list_archs(lm_only: bool = True) -> List[str]:
    return [a for a in _ARCHS if not (lm_only and a == "cgra_amber")]


def _module(name: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(name)}")


def get_config(name: str):
    return _module(name).FULL


def get_smoke(name: str):
    return _module(name).smoke()


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Stand-ins of every model input of one cell on ``device``: token and
    label ids (int64, the index dtype of ``torch.gather``), patches and
    frames in bfloat16, as the reference's ``ShapeDtypeStruct``s.
    Nothing is written into them; under a ``FakeTensorMode`` nothing is
    allocated either."""
    b = shape.global_batch

    def ids(s):
        return torch.empty((b, s), dtype=torch.long, device=device)

    if shape.kind == "train":
        specs = {"tokens": ids(shape.seq_len), "labels": ids(shape.seq_len)}
    elif shape.kind == "prefill":
        specs = {"tokens": ids(shape.seq_len)}
    else:  # decode: one new token against a seq_len-deep cache
        specs = {"tokens": ids(1)}
    if cfg.vlm is not None and shape.kind != "decode":
        specs["patches"] = torch.empty(
            (b, cfg.vlm.num_patches, cfg.vlm.d_patch), dtype=torch.bfloat16,
            device=device)
    if cfg.encdec is not None and shape.kind != "decode":
        specs["frames"] = torch.empty(
            (b, cfg.encdec.encoder_seq, cfg.encdec.d_frame),
            dtype=torch.bfloat16, device=device)
    return specs


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention (the reference's
    DESIGN.md, arch applicability)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False
    return True

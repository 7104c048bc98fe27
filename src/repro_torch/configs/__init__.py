"""Configs of the port (counterpart of repro/configs).

Each module defines ``FULL`` (the published configuration) and
``smoke()`` (a reduced same-family configuration for CPU tests), field
for field the reference's. ``get_config(name)`` / ``get_smoke(name)`` /
``list_archs()`` are the public API, as in the reference: the ten LM
archs and the paper's own artifact (:mod:`cgra_amber`). The reference's
``input_specs`` builds JAX stand-ins for its dry-run, which is not
ported.
"""
from __future__ import annotations

import importlib
from typing import List

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

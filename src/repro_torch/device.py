"""Device resolution for the port's entry points.

``device=None`` means the CUDA card: an entry point asked to run on the
card on a host without one raises instead of quietly running on the CPU.
Callers that want the CPU (the tests) say so with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def on_card(device: DeviceLike = None) -> bool:
    """Whether ``device`` names a CUDA device (``None``, ``"cuda"``,
    ``"cuda:1"``, ...), without asking for one."""
    return torch.device("cuda" if device is None else device).type == "cuda"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port "
            "on the CPU")
    return dev

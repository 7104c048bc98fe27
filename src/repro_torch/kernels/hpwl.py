"""Per-net pin bounding boxes (counterpart of repro/kernels/hpwl.py).

``net_bboxes`` reduces padded ``(n_nets, K, 2)`` pin tables to per-net
``(xmin, xmax, ymin, ymax)`` boxes; masked-out pins read as
``+/-SENTINEL`` and a net with no live pin is the zero box. It seeds the
batched annealer's chain state. CUDA tensors run the hand-written kernel
in ``csrc/hpwl.cu``; CPU tensors the plain PyTorch version beside it.
(The per-net ``hpwl`` kernel of the reference is not ported yet.)
"""
from __future__ import annotations

import torch

from . import build

SENTINEL = 1 << 20


def net_bboxes_plain(pins: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`net_bboxes`."""
    m = mask > 0
    x, y = pins[..., 0], pins[..., 1]
    big = torch.full_like(x, SENTINEL)
    box = torch.stack([
        torch.where(m, x, big).amin(dim=1),
        torch.where(m, x, -big).amax(dim=1),
        torch.where(m, y, big).amin(dim=1),
        torch.where(m, y, -big).amax(dim=1),
    ], dim=1)
    return torch.where(m.any(dim=1)[:, None], box, torch.zeros_like(box))


def net_bboxes(pins: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-net bounding boxes (n_nets, 4) int32 as (xmin, xmax, ymin,
    ymax). pins: (n_nets, K, 2) int32; mask: (n_nets, K) int32, K >= 1."""
    if pins.device.type == "cpu":
        return net_bboxes_plain(pins, mask)
    n, k = mask.shape
    if k < 1:
        raise ValueError("net_bboxes: K must be >= 1")
    build.require("net_bboxes", pins.device, torch.int32, pins=pins,
                  mask=mask)
    build.require_shape("net_bboxes", "pins", pins, (n, k, 2))
    out = torch.empty((n, 4), dtype=torch.int32, device=pins.device)
    if n == 0:
        return out
    err = build.library().canal_net_bboxes(
        pins.data_ptr(), mask.data_ptr(), out.data_ptr(), n, k,
        build.stream_ptr(pins.device))
    build.check(err, "net_bboxes")
    build.LAUNCHES["net_bboxes"] += 1
    return out


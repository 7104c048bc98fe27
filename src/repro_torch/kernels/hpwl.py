"""Per-net pin bounding boxes and HPWL (counterpart of
repro/kernels/hpwl.py).

Both kernels reduce padded ``(n_nets, K, 2)`` pin tables, with masked-out
pins read as ``+/-SENTINEL``:

* ``net_bboxes`` — per-net ``(xmin, xmax, ymin, ymax)`` boxes, the zero
  box for a net with no live pin; it seeds the batched annealer's chain
  state.
* ``hpwl`` — per-net half-perimeter wirelength ``(xmax - xmin) +
  (ymax - ymin)``, the Eq. 2 distance term; 0 for a net with no live pin.

CUDA tensors run the hand-written kernels in ``csrc/hpwl.cu``; CPU
tensors the plain PyTorch versions beside them.
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


def hpwl_plain(pins: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`hpwl` (int32 wrap-around, as the
    reference's jnp arithmetic)."""
    box = net_bboxes_plain(pins, mask).long()
    w = (box[:, 1] - box[:, 0]) + (box[:, 3] - box[:, 2])
    return (((w + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _launch(kernel: str, pins: torch.Tensor, mask: torch.Tensor,
            out_cols: int) -> torch.Tensor:
    n, k = mask.shape
    if k < 1:
        raise ValueError(f"{kernel}: K must be >= 1")
    build.require(kernel, pins.device, torch.int32, pins=pins, mask=mask)
    build.require_shape(kernel, "pins", pins, (n, k, 2))
    shape = (n, out_cols) if out_cols > 1 else (n,)
    out = torch.empty(shape, dtype=torch.int32, device=pins.device)
    if n == 0:
        return out
    err = getattr(build.library(), f"canal_{kernel}")(
        pins.data_ptr(), mask.data_ptr(), out.data_ptr(), n, k,
        build.stream_ptr(pins.device))
    build.check(err, kernel)
    build.LAUNCHES[kernel] += 1
    return out


def hpwl(pins: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-net HPWL (n_nets,) int32. pins: (n_nets, K, 2) int32; mask:
    (n_nets, K) int32, K >= 1."""
    if pins.device.type == "cpu":
        return hpwl_plain(pins, mask)
    return _launch("hpwl", pins, mask, 1)


def net_bboxes(pins: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-net bounding boxes (n_nets, 4) int32 as (xmin, xmax, ymin,
    ymax). pins: (n_nets, K, 2) int32; mask: (n_nets, K) int32, K >= 1."""
    if pins.device.type == "cpu":
        return net_bboxes_plain(pins, mask)
    return _launch("net_bboxes", pins, mask, 4)


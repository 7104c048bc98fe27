"""Per-net pin bounding boxes and HPWL (counterpart of
repro/kernels/hpwl.py).

Both kernels reduce padded ``(n_nets, K, 2)`` pin tables, with masked-out
pins read as ``+/-SENTINEL``:

* ``net_bboxes`` — per-net ``(xmin, xmax, ymin, ymax)`` boxes, the zero
  box for a net with no live pin; it seeds the batched annealer's chain
  state.
* ``hpwl`` — per-net half-perimeter wirelength ``(xmax - xmin) +
  (ymax - ymin)``, the Eq. 2 distance term; 0 for a net with no live pin.

CUDA tensors run the hand-written kernels in ``csrc/hpwl.cu`` (a group
of lanes a net, sized by :func:`box_tiles`); CPU tensors the plain
PyTorch versions beside them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .fabric_step import SM_COUNT, SM_THREADS

SENTINEL = 1 << 20
#: the kernels' block, and the widest group of lanes a net
BOX_THREADS = 256
BOX_MAX_GROUP = 32


def box_group(k: int) -> int:
    """Lanes a net: the least power of two at least K, at most 32 (past
    32 pins the lanes stride over K)."""
    g = 1
    while g < min(k, BOX_MAX_GROUP):
        g *= 2
    return g


def box_tiles(n: int, k: int) -> Tuple[int, int, int]:
    """The size rule of both kernels: ``(G, blocks, threads)``.

    Group w of the grid's W = blocks x threads / G groups of G lanes
    takes nets w, w + W, ...; a warp holds 32 / G consecutive nets.
    Blocks of ``BOX_THREADS`` (a block of one warp is slower at the
    path's dozen nets), as many as cover the nets, at least one and at
    most as many as the card holds at once (``SM_COUNT x SM_THREADS /
    BOX_THREADS``), past which groups stride. The rule reads n and K
    only."""
    g = box_group(k)
    blocks = -(-max(n, 1) * g // BOX_THREADS)
    return g, min(blocks, SM_COUNT * SM_THREADS // BOX_THREADS), BOX_THREADS


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
    aligned = pins.data_ptr() % 8 == 0          # one int2 load a pin
    err = getattr(build.library(), f"canal_{kernel}")(
        pins.data_ptr(), mask.data_ptr(), out.data_ptr(), n, k,
        *box_tiles(n, k), int(aligned), build.stream_ptr(pins.device))
    build.check(err, kernel)
    if not torch.cuda.is_current_stream_capturing():
        build.count_launch(kernel)
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


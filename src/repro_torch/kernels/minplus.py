"""Min-plus (tropical) relaxation for routing wavefronts (counterpart of
repro/kernels/minplus.py).

    d'[b, j] = min(d[b, j], min_i (d[b, i] + w[i, j]))

for a batch of cost vectors over the dense, INF-padded coarse routing
graph (one node per tile). ``minplus_step`` is one relaxation, the
hand-written CUDA kernel in ``csrc/minplus.cu`` for CUDA tensors and the
plain PyTorch version beside it for CPU tensors; ``minplus_wavefront``
iterates it in blocks to the fixpoint, with the reference's stop and cap
contract. Both versions are exact: every candidate is a single rounded
float add and ``min`` is exact, so they agree bit for bit.
"""
from __future__ import annotations

import torch

from . import build

#: "no edge"; two of these still add without overflowing to inf
INF = 3.0e38 / 4


def minplus_step_plain(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`minplus_step`."""
    return torch.minimum(d, torch.amin(d[:, :, None] + w[None], dim=1))


def minplus_step(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One relaxation: min(d, d (x) w). d: (B, N) float32; w: (N, N)
    float32 INF-padded adjacency with w[i, i] = 0."""
    if d.device.type == "cpu":
        return minplus_step_plain(d, w)
    b, n = d.shape
    build.require("minplus_step", d.device, torch.float32, d=d, w=w)
    build.require_shape("minplus_step", "w", w, (n, n))
    out = torch.empty_like(d)
    if b == 0 or n == 0:
        return out
    err = build.library().canal_minplus_step(
        d.data_ptr(), w.data_ptr(), out.data_ptr(), b, n,
        build.stream_ptr(d.device))
    build.check(err, "minplus_step")
    build.count_launch("minplus_step")
    return out


def minplus_fixpoint(d0: torch.Tensor, w: torch.Tensor,
                     iters: int) -> torch.Tensor:
    """``iters`` relaxations."""
    d = d0
    for _ in range(iters):
        d = minplus_step(d, w)
    return d


def minplus_wavefront(d0: torch.Tensor, w: torch.Tensor,
                      block_iters: int = 8) -> torch.Tensor:
    """Relax ``d0`` to the shortest-path fixpoint, adaptively: blocks of
    ``block_iters`` relaxations, stopping at the first block that leaves
    the field unchanged (one device-side ``torch.equal`` per block), and
    capped at ``N - 1`` relaxations (the Bellman-Ford bound)."""
    d = d0.to(torch.float32)
    w = w.to(torch.float32)
    n = w.shape[0]
    max_blocks = max(1, -(-max(n - 1, 1) // block_iters))
    for _ in range(max_blocks):
        nd = minplus_fixpoint(d, w, block_iters)
        if torch.equal(nd, d):
            return nd
        d = nd
    return d

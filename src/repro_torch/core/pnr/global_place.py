"""Analytical global placement (§3.4, Eq. 1).

Minimizes Σ_net ( HPWL_estimate + MEM_potential ) where the HPWL estimate is
the quadratic (L2) star model — "In global placement, we use L2 distance to
approximate the HPWL to speed up the algorithm" — solved with the standard
conjugate gradient method (the paper cites APlace's CG approach). Memory
legalization is the usual anchor-iteration: each outer round adds springs
pulling MEM instances to their nearest legal column, then re-solves.

The quadratic solve runs in PyTorch on the placer's device (a scatter-add
matvec and a conjugate gradient with the reference's ``jax.scipy`` CG
stopping rule), so the placer itself is a dense array program.
(Counterpart of repro/core/pnr/global_place.py.)
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from .packing import PackedGraph


def conjugate_gradient(matvec: Callable[[torch.Tensor], torch.Tensor],
                       b: torch.Tensor, x0: torch.Tensor, tol: float = 1e-5,
                       atol: float = 0.0, maxiter: int = 200) -> torch.Tensor:
    """Unpreconditioned CG for a symmetric positive (semi-)definite
    operator, step for step the ``jax.scipy.sparse.linalg.cg`` loop:
    stop once ``||r||^2 <= max(tol^2 ||b||^2, atol^2)`` or after
    ``maxiter`` iterations."""
    tol2 = torch.square(torch.tensor(tol, dtype=b.dtype, device=b.device))
    atol2 = torch.clamp(tol2 * torch.dot(b, b), min=atol * atol)
    x = x0
    r = b - matvec(x0)
    p = r
    gamma = torch.dot(r, r)
    k = 0
    while k < maxiter and bool(gamma > atol2):
        ap = matvec(p)
        alpha = gamma / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        gamma_new = torch.dot(r, r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x


def _io_ring_positions(w: int, h: int) -> List[Tuple[int, int]]:
    """Clockwise ring coordinates, corners excluded (a corner tile with
    depopulated SB sides can have no legal fabric connection)."""
    ring = [(x, 0) for x in range(1, w - 1)]
    ring += [(w - 1, y) for y in range(1, h - 1)]
    ring += [(x, h - 1) for x in range(w - 2, 0, -1)]
    ring += [(0, y) for y in range(h - 2, 0, -1)]
    return ring


def assign_ios(packed: PackedGraph, w: int, h: int) -> Dict[str,
                                                            Tuple[int, int]]:
    """Spread IO instances evenly around the array border."""
    ios = [n for n, inst in packed.placeable.items()
           if inst.kind in ("io_in", "io_out")]
    ring = _io_ring_positions(w, h)
    if len(ios) > len(ring):
        raise ValueError("more IOs than border tiles")
    stride = max(1, len(ring) // max(len(ios), 1))
    return {name: ring[(i * stride) % len(ring)]
            for i, name in enumerate(ios)}


def global_place(packed: PackedGraph, width: int, height: int,
                 mem_columns: Sequence[int] = (),
                 fixed: Optional[Dict[str, Tuple[int, int]]] = None,
                 outer_iters: int = 4, cg_tol: float = 1e-5,
                 seed: int = 0, device: DeviceLike = None
                 ) -> Dict[str, Tuple[float, float]]:
    """Continuous positions for every placeable instance (fixed IOs pinned).

    Returns name -> (x, y) float positions (pre-legalization).
    """
    if fixed is None:
        fixed = assign_ios(packed, width, height)

    movable = [n for n in packed.placeable if n not in fixed]
    m_idx = {n: i for i, n in enumerate(movable)}
    n_mov = len(movable)
    is_mem = np.array(
        [packed.placeable[n].kind == "mem" for n in movable], dtype=bool)

    if n_mov == 0:
        return {k: (float(x), float(y)) for k, (x, y) in fixed.items()}
    dev = resolve_device(device)

    # ---- net pin tables ---------------------------------------------------
    pin_net: List[int] = []
    pin_mov: List[int] = []          # movable index or -1
    pin_fix: List[Tuple[float, float]] = []
    n_nets = 0
    for net in packed.nets:
        members = [net.src[0]] + [s for s, _ in net.sinks]
        members = [m for m in members if m in packed.placeable]
        if len(members) < 2:
            continue
        for mname in members:
            pin_net.append(n_nets)
            if mname in m_idx:
                pin_mov.append(m_idx[mname])
                pin_fix.append((0.0, 0.0))
            else:
                pin_mov.append(-1)
                fx, fy = fixed[mname]
                pin_fix.append((float(fx), float(fy)))
        n_nets += 1

    pin_net_a = torch.as_tensor(np.array(pin_net, np.int64), device=dev)
    pin_mov_a = torch.as_tensor(np.array(pin_mov, np.int64), device=dev)
    pin_fix_a = torch.as_tensor(
        np.array(pin_fix, np.float32).reshape(-1, 2), device=dev)
    n_seg = max(n_nets, 1)
    net_size = torch.zeros(n_seg, device=dev).index_add_(
        0, pin_net_a, torch.ones(len(pin_net), device=dev))
    mov_c = torch.clamp(pin_mov_a, 0, n_mov - 1)
    is_mov = (pin_mov_a >= 0)[:, None]

    def pin_positions(x: torch.Tensor) -> torch.Tensor:
        """x: (n_mov, 2) -> (n_pins, 2)."""
        return torch.where(is_mov, x[mov_c], pin_fix_a)

    def grad_quadratic(x: torch.Tensor, anchor_w: torch.Tensor,
                       anchor_p: torch.Tensor) -> torch.Tensor:
        """Gradient of Σ_net Σ_pins ||p − c_net||² + Σ anchors, wrt x."""
        p = pin_positions(x)
        c = (torch.zeros((n_seg, 2), device=dev).index_add_(0, pin_net_a, p)
             / torch.clamp(net_size, min=1.0)[:, None])
        resid = p - c[pin_net_a]
        g = torch.zeros_like(x).index_add_(
            0, mov_c, torch.where(is_mov, resid, torch.zeros_like(resid)))
        g = g + anchor_w[:, None] * (x - anchor_p)
        return 2.0 * g

    # The cost is quadratic ⇒ grad is affine in x: solve A x = b with CG,
    # where A x = grad(x) − grad(0) and b = −grad(0).
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(
        rng.uniform([width * .25, height * .25],
                    [width * .75, height * .75],
                    size=(n_mov, 2)).astype(np.float32), device=dev)
    anchor_w = torch.zeros((n_mov,), device=dev)
    anchor_p = torch.zeros((n_mov, 2), device=dev)
    mem_cols = np.array(sorted(mem_columns), np.float32)
    hi = torch.tensor([width - 1.0, height - 1.0], device=dev)

    for outer in range(outer_iters):
        g0 = grad_quadratic(torch.zeros_like(x), anchor_w, anchor_p)

        def matvec(v):
            return (grad_quadratic(v.reshape(n_mov, 2), anchor_w, anchor_p)
                    - g0).reshape(-1)

        b = (-g0).reshape(-1)
        sol = conjugate_gradient(matvec, b, x.reshape(-1), tol=cg_tol,
                                 maxiter=200)
        x = torch.minimum(torch.clamp(sol.reshape(n_mov, 2), min=0.0), hi)

        # MEM_potential: anchor memories to their nearest legal column
        if len(mem_cols) and is_mem.any():
            xx = x.cpu().numpy()
            tgt = xx.copy()
            col = mem_cols[np.argmin(
                np.abs(xx[:, :1] - mem_cols[None, :]), axis=1)]
            tgt[:, 0] = np.where(is_mem, col, xx[:, 0])
            w_new = np.where(is_mem, 0.5 * (outer + 1), 0.0) \
                .astype(np.float32)
            anchor_w = torch.as_tensor(w_new, device=dev)
            anchor_p = torch.as_tensor(tgt.astype(np.float32), device=dev)

    out = {k: (float(px), float(py)) for k, (px, py) in fixed.items()}
    xx = x.cpu().numpy()
    for name, i in m_idx.items():
        out[name] = (float(xx[i, 0]), float(xx[i, 1]))
    return out


def legalize(packed: PackedGraph, positions: Dict[str, Tuple[float, float]],
             width: int, height: int, mem_columns: Sequence[int] = (),
             io_ring: bool = True,
             fixed: Optional[Dict[str, Tuple[int, int]]] = None
             ) -> Dict[str, Tuple[int, int]]:
    """Snap continuous positions to distinct legal tiles (greedy nearest)."""
    mem_cols = set(mem_columns)
    occupied: Dict[Tuple[int, int], str] = {}
    out: Dict[str, Tuple[int, int]] = {}
    fixed = fixed or {}

    def legal_for(inst_kind: str, x: int, y: int) -> bool:
        border = x in (0, width - 1) or y in (0, height - 1)
        if inst_kind in ("io_in", "io_out"):
            return border if io_ring else True
        if io_ring and border:
            return False
        if inst_kind == "mem":
            return x in mem_cols if mem_cols else True
        return x not in mem_cols           # PEs keep off mem columns

    for name, pos in fixed.items():
        occupied[pos] = name
        out[name] = pos

    order = sorted((n for n in packed.placeable if n not in fixed),
                   key=lambda n: (packed.placeable[n].kind != "mem",
                                  positions[n]))
    for name in order:
        kind = packed.placeable[name].kind
        px, py = positions[name]
        best = None
        for r in range(width + height):
            cands = []
            for dx in range(-r, r + 1):
                for dy in (-r + abs(dx), r - abs(dx)):
                    x, y = int(round(px)) + dx, int(round(py)) + dy
                    if 0 <= x < width and 0 <= y < height \
                            and (x, y) not in occupied \
                            and legal_for(kind, x, y):
                        cands.append((abs(x - px) + abs(y - py), x, y))
            if cands:
                _, x, y = min(cands)
                best = (x, y)
                break
        if best is None:
            raise ValueError(f"cannot legalize {name} ({kind})")
        occupied[best] = name
        out[name] = best
    return out

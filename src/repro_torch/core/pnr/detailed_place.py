"""Detailed placement via simulated annealing (§3.4, Eq. 2).

Cost_net = (HPWL_net − γ · (Area_net ∩ Area_existing))^α

γ penalizes pass-through tiles (rewards nets whose bounding boxes overlap
already-used tiles, so routing reuses powered-on tiles); α penalizes long
potential routes. The paper sweeps α from 1 to 20 and keeps the best
post-route result.

Device adaptation: instead of one-move-at-a-time CPU annealing, we evaluate a
*batch* of candidate swaps per temperature step with a dense, vectorized
cost (per-net bounding boxes via segment min/max + an occupancy integral
image for the overlap term), then accept the best Metropolis-passing move.
(Counterpart of repro/core/pnr/detailed_place.py; the costs run in
PyTorch on the placer's device, per-net boxes via ``scatter_reduce``.)

Two engines sit behind the ``strategy=`` knob (mirroring the router's
``route_strategy``):

* ``"python"`` — the host loop below: the differential oracle. One
  chain, Python-side proposal, one device round-trip per step.
* ``"batched"`` — :mod:`batched_anneal`: K parallel-tempering chains as
  one device-resident loop (no per-step host sync).
* ``"auto"`` — ``"batched"`` on fabrics with at least
  ``_PLACE_AUTO_MIN_TILES`` tiles (env-overridable via
  ``CANAL_PLACE_AUTO_MIN_TILES``), ``"python"`` below it, where the
  host loop's lower fixed cost wins.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from .packing import PackedGraph

_log = logging.getLogger(__name__)

#: "auto" strategy switches to the device-resident chains at this tile
#: count. Default only — override per process via the
#: CANAL_PLACE_AUTO_MIN_TILES env var (same calibration story as the
#: router's CANAL_AUTO_MIN_TILES).
_PLACE_AUTO_MIN_TILES = 49

PLACE_STRATEGIES = ("python", "batched", "auto")


def place_auto_min_tiles_threshold(explicit: Optional[int] = None) -> int:
    """Resolve the "auto" placement threshold: explicit override >
    ``CANAL_PLACE_AUTO_MIN_TILES`` env var > module default."""
    if explicit is not None:
        return int(explicit)
    env = os.environ.get("CANAL_PLACE_AUTO_MIN_TILES")
    if env is not None:
        try:
            return int(env)
        except ValueError:
            _log.warning("ignoring non-integer "
                         "CANAL_PLACE_AUTO_MIN_TILES=%r", env)
    return _PLACE_AUTO_MIN_TILES


def resolve_place_strategy(n_tiles: int, strategy: str,
                           auto_min_tiles: Optional[int] = None) -> str:
    """Resolve a placement-strategy knob to a concrete engine name."""
    if strategy in ("python", "batched"):
        return strategy
    if strategy == "auto":
        threshold = place_auto_min_tiles_threshold(auto_min_tiles)
        picked = "batched" if n_tiles >= threshold else "python"
        _log.info("place strategy auto -> %s (%d tiles, threshold %d)",
                  picked, n_tiles, threshold)
        return picked
    raise ValueError(f"unknown placement strategy {strategy!r}; "
                     f"expected one of {PLACE_STRATEGIES}")


class _Nets:
    """Dense pin tables for vectorized cost evaluation."""

    def __init__(self, packed: PackedGraph, inst_order: List[str],
                 device: torch.device):
        idx = {n: i for i, n in enumerate(inst_order)}
        pin_net: List[int] = []
        pin_inst: List[int] = []
        self.n_nets = 0
        for net in packed.nets:
            members = [net.src[0]] + [s for s, _ in net.sinks]
            members = [m for m in members if m in idx]
            if len(members) < 2:
                continue
            for m in members:
                pin_net.append(self.n_nets)
                pin_inst.append(idx[m])
            self.n_nets += 1
        self.pin_net = torch.as_tensor(np.array(pin_net, np.int64),
                                       device=device)
        self.pin_inst = torch.as_tensor(np.array(pin_inst, np.int64),
                                        device=device)


def _net_cost(pos: torch.Tensor, nets: _Nets, occ_grid: torch.Tensor,
              gamma: float, alpha: float) -> torch.Tensor:
    """Eq. 2 cost per placement. pos: (C, n_inst, 2) int tile coords;
    occ_grid: (C, W, H) occupancy. Returns (C,) float32."""
    c = pos.shape[0]
    p = pos[:, nets.pin_inst]                            # (C, n_pins, 2)
    n = max(nets.n_nets, 1)
    seg = nets.pin_net[None, :].expand(c, -1)

    def reduce(vals, how):
        out = torch.zeros((c, n), dtype=vals.dtype, device=vals.device)
        return out.scatter_reduce(1, seg, vals, how, include_self=False)

    xmax, xmin = reduce(p[..., 0], "amax"), reduce(p[..., 0], "amin")
    ymax, ymin = reduce(p[..., 1], "amax"), reduce(p[..., 1], "amin")
    hpwl = (xmax - xmin + ymax - ymin).to(torch.float32)

    # Area_net ∩ Area_existing via an occupancy integral image
    ii = torch.cumsum(torch.cumsum(occ_grid, dim=1), dim=2)
    ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))       # (C, W+1, H+1)
    rows = torch.arange(c, device=pos.device)[:, None]
    overlap = (ii[rows, xmax + 1, ymax + 1] - ii[rows, xmin, ymax + 1]
               - ii[rows, xmax + 1, ymin] + ii[rows, xmin, ymin])
    base = torch.clamp(hpwl - gamma * overlap.to(torch.float32), min=1.0)
    return torch.sum(base ** alpha, dim=1)


def detailed_place(packed: PackedGraph,
                   placement: Dict[str, Tuple[int, int]],
                   width: int, height: int,
                   mem_columns: Sequence[int] = (),
                   io_ring: bool = True,
                   gamma: float = 0.3, alpha: float = 2.0,
                   n_steps: int = 300, batch: int = 64,
                   t0: float = 2.0, t_min: float = 0.01,
                   seed: int = 0,
                   strategy: str = "python",
                   device: DeviceLike = None
                   ) -> Dict[str, Tuple[int, int]]:
    """Anneal the legalized placement. Only movable (pe/mem) instances move;
    swaps stay within compatible tile sets.

    ``strategy`` selects the engine: the host loop below (``"python"``,
    the oracle), the device-resident parallel-tempering chains
    (``"batched"``, :func:`batched_anneal.batched_place` with
    ``batch`` chains), or ``"auto"`` (tile-count switch). Costs run on
    ``device`` (``None``: the CUDA card)."""
    strat = resolve_place_strategy(width * height, strategy)
    if strat == "batched":
        from .batched_anneal import batched_place
        return batched_place(packed, placement, width, height,
                             mem_columns=mem_columns, io_ring=io_ring,
                             gamma=gamma, alpha=alpha, n_steps=n_steps,
                             n_chains=batch, t0=t0, t_min=t_min,
                             seed=seed, device=device)
    dev = resolve_device(device)
    inst_order = list(packed.placeable)
    idx = {n: i for i, n in enumerate(inst_order)}
    nets = _Nets(packed, inst_order, dev)
    if nets.n_nets == 0:
        return dict(placement)

    movable = [n for n in inst_order
               if packed.placeable[n].kind in ("pe", "mem")]
    if len(movable) == 0:
        return dict(placement)

    mem_cols = set(mem_columns)

    def tile_class(kind: str, x: int, y: int) -> str:
        if x in mem_cols:
            return "mem"
        return "pe"

    # legal empty tiles per class (move targets)
    used = set(placement.values())
    empties: Dict[str, List[Tuple[int, int]]] = {"pe": [], "mem": []}
    for x in range(width):
        for y in range(height):
            border = x in (0, width - 1) or y in (0, height - 1)
            if io_ring and border:
                continue
            if (x, y) in used:
                continue
            empties[tile_class("", x, y)].append((x, y))

    pos = np.array([placement[n] for n in inst_order], np.int32)
    mov_ids = np.array([idx[n] for n in movable], np.int32)
    mov_kind = [packed.placeable[n].kind for n in movable]

    occ = np.zeros((width, height), np.float32)
    for (x, y) in placement.values():
        occ[x, y] = 1.0

    def batch_cost(p: np.ndarray, o: np.ndarray) -> np.ndarray:
        return _net_cost(torch.as_tensor(p, device=dev).long(), nets,
                         torch.as_tensor(o, device=dev), gamma,
                         alpha).cpu().numpy()

    rng = np.random.default_rng(seed)
    cur_cost = float(batch_cost(pos[None], occ[None])[0])
    temp = t0
    decay = (t_min / t0) ** (1.0 / max(n_steps, 1))

    for step in range(n_steps):
        # ---- propose a batch of moves ------------------------------------
        cand_pos = np.repeat(pos[None], batch, axis=0)
        cand_occ = np.repeat(occ[None], batch, axis=0)
        descr: List[Tuple] = []
        for b in range(batch):
            mi = rng.integers(len(movable))
            i = mov_ids[mi]
            kind = mov_kind[mi]
            cls = "mem" if kind == "mem" else "pe"
            x0, y0 = cand_pos[b, i]
            if empties[cls] and rng.random() < 0.4:
                x1, y1 = empties[cls][rng.integers(len(empties[cls]))]
                cand_pos[b, i] = (x1, y1)
                cand_occ[b, x0, y0] = 0.0
                cand_occ[b, x1, y1] = 1.0
                descr.append(("move", i, (x0, y0), (x1, y1)))
            else:
                mj = rng.integers(len(movable))
                j = mov_ids[mj]
                same = (("mem" if mov_kind[mj] == "mem" else "pe") == cls)
                if i == j or not same:
                    descr.append(None)
                    continue
                x1, y1 = cand_pos[b, j]
                cand_pos[b, i], cand_pos[b, j] = (x1, y1), (x0, y0)
                descr.append(("swap", i, j))

        costs = batch_cost(cand_pos, cand_occ)
        order = np.argsort(costs)
        # ---- accept the best Metropolis-passing proposal -----------------
        # cheapest-first: each candidate gets its own Metropolis draw, and
        # the first (i.e. best) passer is applied — a rejected candidate
        # falls through to the next-best instead of ending the step
        for b in order:
            if descr[b] is None:
                continue
            d = costs[b] - cur_cost
            if d < 0 or rng.random() < np.exp(-d / max(temp, 1e-6)):
                pos = cand_pos[b]
                occ = cand_occ[b]
                cur_cost = float(costs[b])
                if descr[b][0] == "move":
                    _, _, old, new = descr[b]
                    cls = tile_class("", *new)
                    empties[cls].remove(new)
                    empties[tile_class("", *old)].append(old)
                break
        temp *= decay

    return {n: (int(pos[idx[n], 0]), int(pos[idx[n], 1]))
            for n in inst_order}

"""Device-resident batched annealing placement (§3.4, Eq. 2), in PyTorch
(counterpart of repro/core/pnr/batched_anneal.py).

The host annealer in :mod:`detailed_place` proposes moves in a Python
loop and round-trips to the device once per temperature step to score a
candidate batch. This module keeps the whole anneal on the device:

* K independent annealing chains advance together, the chain axis a
  batch dimension, in one loop over temperature steps; move proposal
  draws from one explicit ``torch.Generator`` seeded from ``seed``
  (seed-deterministic across processes; the numbers differ from the
  reference's ``jax.random`` streams).
* Moves are encoded as (instance, target-slot) pairs over a dense
  *legal-tile table* partitioned by tile class (PE tiles vs memory
  columns, IO ring excluded), so mem-column / IO-ring legality holds by
  construction — an illegal placement is unrepresentable.
* Each chain scores a small candidate batch per step and applies the
  cheapest Metropolis-passing candidate (every candidate draws its own
  uniform, the accepted one is the min-cost passer).
* Eq. 2 cost deltas are incremental: only the nets touching the moved
  instances re-reduce their pin bounding boxes; the overlap term reads
  a per-candidate occupancy integral image. The full per-net reduction —
  used to seed the chain state — is the ``net_bboxes`` kernel
  (``repro_torch.kernels.hpwl``) on padded ``(n_nets, K, 2)`` pin tables.
* Chains sit on a geometric temperature ladder and periodically attempt
  replica exchange between neighbours (parallel tempering), so hot
  chains feed escapes to cold ones; the best placement seen by any
  chain wins.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

from .packing import PackedGraph

#: candidate proposals per chain per temperature step
DEFAULT_CANDS = 4
#: temperature-ladder span: the hottest chain anneals this many times
#: hotter than the coldest (chain 0) at every step
DEFAULT_LADDER = 3.0
#: steps between replica-exchange attempts (even/odd neighbour pairs
#: alternate, so the whole ladder mixes)
DEFAULT_EXCHANGE_EVERY = 16

# ---------------------------------------------------------------------------
# Host-side table construction
# ---------------------------------------------------------------------------

def _net_members(packed: PackedGraph,
                 idx: Dict[str, int]) -> List[List[int]]:
    """Per-net placeable member instance indices (>=2 members only)."""
    out: List[List[int]] = []
    for net in packed.nets:
        members = [net.src[0]] + [s for s, _ in net.sinks]
        members = [idx[m] for m in members if m in idx]
        if len(members) >= 2:
            out.append(members)
    return out


def _legal_slot_tables(packed: PackedGraph,
                       placement: Dict[str, Tuple[int, int]],
                       movable: List[str],
                       width: int, height: int,
                       mem_columns: Sequence[int],
                       io_ring: bool):
    """The dense legal-tile tables that make moves legal by construction.

    Tiles are partitioned into classes — ``mem`` (memory columns, when
    any are declared) and ``pe`` (everything else) — minus the IO ring
    border (when enabled) and tiles pinned by immovable instances. Each
    movable instance draws move targets only from its own class range,
    mirroring :func:`global_place.legalize`'s ``legal_for`` rules."""
    mem_cols = set(int(c) for c in mem_columns)
    fixed_tiles = {placement[n] for n in placement if n not in set(movable)}
    tiles: Dict[str, List[Tuple[int, int]]] = {"pe": [], "mem": []}
    for x in range(width):
        for y in range(height):
            if io_ring and (x in (0, width - 1) or y in (0, height - 1)):
                continue
            if (x, y) in fixed_tiles:
                continue
            cls = "mem" if (mem_cols and x in mem_cols) else "pe"
            tiles[cls].append((x, y))

    slot_xy = np.array(tiles["pe"] + tiles["mem"], np.int32)
    ranges = {"pe": (0, len(tiles["pe"])),
              "mem": (len(tiles["pe"]), len(tiles["mem"]))}
    tile_slot = {tuple(t): s for s, t in enumerate(slot_xy.tolist())}

    inst_lo = np.zeros(len(movable), np.int32)
    inst_size = np.zeros(len(movable), np.int32)
    slot0 = np.zeros(len(movable), np.int32)
    for i, name in enumerate(movable):
        kind = packed.placeable[name].kind
        cls = "mem" if (kind == "mem" and mem_cols) else "pe"
        lo, size = ranges[cls]
        if size == 0:
            raise ValueError(f"no legal tiles for {name} (class {cls})")
        inst_lo[i], inst_size[i] = lo, size
        tile = tuple(placement[name])
        if tile not in tile_slot or not lo <= tile_slot[tile] < lo + size:
            raise ValueError(
                f"instance {name} at {tile} is outside its legal tile "
                f"class {cls!r} — batched placement needs a legal seed")
        slot0[i] = tile_slot[tile]
    return slot_xy, inst_lo, inst_size, slot0



def _eq2_terms(bboxes: torch.Tensor, occ: torch.Tensor,
               gamma: float, alpha: float) -> torch.Tensor:
    """Per-net Eq. 2 terms from (..., n, 4) boxes and a (..., W, H)
    occupancy grid with the same leading dims."""
    h1 = occ.shape[-1] + 1
    ii = torch.nn.functional.pad(
        torch.cumsum(torch.cumsum(occ, dim=-2), dim=-1), (1, 0, 1, 0))
    ii = ii.reshape(ii.shape[:-2] + (-1,))
    x0, x1 = bboxes[..., 0].long(), bboxes[..., 1].long()
    y0, y1 = bboxes[..., 2].long(), bboxes[..., 3].long()

    def at(x, y):
        return torch.gather(ii, -1, x * h1 + y)

    overlap = (at(x1 + 1, y1 + 1) - at(x0, y1 + 1)
               - at(x1 + 1, y0) + at(x0, y0)).to(torch.float32)
    hpwl = ((x1 - x0) + (y1 - y0)).to(torch.float32)
    return torch.clamp(hpwl - gamma * overlap, min=1.0) ** alpha


def eq2_cost(packed: PackedGraph, placement: Dict[str, Tuple[int, int]],
             width: int, height: int,
             gamma: float = 0.3, alpha: float = 2.0,
             device: DeviceLike = None) -> float:
    """The exact Eq. 2 cost of a placement (per-net boxes via the
    ``net_bboxes`` kernel) — the common yardstick the host oracle and the
    batched chains are compared on."""
    dev = resolve_device(device)
    inst_order = list(packed.placeable)
    idx = {n: i for i, n in enumerate(inst_order)}
    members = _net_members(packed, idx)
    if not members:
        return 0.0
    kp = max(len(m) for m in members)
    pins = np.zeros((len(members), kp, 2), np.int32)
    mask = np.zeros((len(members), kp), np.int32)
    for n, mem in enumerate(members):
        for j, gi in enumerate(mem):
            pins[n, j] = placement[inst_order[gi]]
            mask[n, j] = 1
    bboxes = ops.net_bboxes(torch.as_tensor(pins, device=dev),
                            torch.as_tensor(mask, device=dev))
    occ = np.zeros((width, height), np.float32)
    for (x, y) in placement.values():
        occ[x, y] = 1.0
    terms = _eq2_terms(bboxes, torch.as_tensor(occ, device=dev), gamma,
                       alpha)
    return float(torch.sum(terms))


# ---------------------------------------------------------------------------
# The device program
# ---------------------------------------------------------------------------

def _anneal(slot_xy, mov_gid, inst_lo, inst_size, net_pins, net_mask,
            mov_nets, pos0, occ0, slot0, owner0, bbox0,
            gen: torch.Generator, gamma: float, alpha: float, t0: float,
            t_min: float, ladder: float, n_steps: int, n_chains: int,
            cands: int, exchange_every: int):
    """K parallel-tempering annealing chains, stepped together.

    All tables are int64 / float32 tensors on one device; ``bbox0`` is
    ``(n_nets + 1, 4)`` (the trailing row is the scatter sink for padded
    affected-net slots). Returns ``(best_slot, best_cost)`` stacked over
    chains."""
    dev = slot0.device
    n_mov = slot0.shape[0]
    n_nets = bbox0.shape[0] - 1
    w, h = occ0.shape
    k_, c_ = n_chains, cands
    chain = torch.arange(k_, device=dev)
    kc = chain[:, None].expand(k_, c_)
    cc = torch.arange(c_, device=dev)[None, :].expand(k_, c_)
    decay = (t_min / t0) ** (1.0 / max(n_steps, 1))
    #: chain k anneals ladder**(k/(K-1)) hotter than chain 0
    ladder_f = ladder ** (chain.to(torch.float32) / max(k_ - 1, 1))
    big = 1 << 20

    def tile(x):
        return x.expand((k_,) + tuple(x.shape)).clone()

    cost0 = torch.sum(_eq2_terms(bbox0[:n_nets], occ0, gamma, alpha))
    slot, owner, pos = tile(slot0), tile(owner0), tile(pos0)
    occ, bbox = tile(occ0), tile(bbox0)
    cost = cost0.expand(k_).clone()
    best_cost, best_slot = cost.clone(), slot.clone()

    for t in range(n_steps):
        temps = (t0 * decay ** t) * ladder_f
        mi = torch.randint(0, n_mov, (k_, c_), generator=gen, device=dev)
        draw = torch.randint(0, 1 << 30, (k_, c_), generator=gen,
                             device=dev)
        tgt = inst_lo[mi] + draw % inst_size[mi]
        u = torch.rand((k_, c_), generator=gen, device=dev)

        # ---- every candidate of every chain, scored at once -------------
        src = torch.gather(slot, 1, mi)
        j = torch.gather(owner, 1, tgt)                # another movable, -1
        valid = tgt != src
        swap = j >= 0
        jc = torch.clamp(j, min=0)
        gi = mov_gid[mi]
        gj = torch.where(swap, mov_gid[jc], gi)
        xy_i = slot_xy[tgt]                            # (K, C, 2)
        sxy = slot_xy[src]
        xy_j = torch.where(swap[..., None], sxy, xy_i)
        # occupancy moves only on a relocate (swap leaves it fixed)
        docc = torch.where(swap, 0.0, 1.0).reshape(-1)
        occ2 = occ[:, None].expand(k_, c_, w, h).reshape(k_ * c_, w * h)
        occ2 = occ2.clone()
        rows = torch.arange(k_ * c_, device=dev)
        occ2.index_put_((rows, (sxy[..., 0] * h + sxy[..., 1]).reshape(-1)),
                        -docc, accumulate=True)
        occ2.index_put_((rows, (xy_i[..., 0] * h + xy_i[..., 1]).reshape(-1)),
                        docc, accumulate=True)
        occ2 = occ2.reshape(k_, c_, w, h)
        # incremental re-reduce: only nets touching the movers
        aff = torch.cat([mov_nets[mi],
                         torch.where(swap[..., None], mov_nets[jc],
                                     torch.full_like(mov_nets[jc], -1))],
                        dim=-1)                        # (K, C, 2M)
        live = aff >= 0
        affc = torch.clamp(aff, min=0)
        pidx = net_pins[affc]                          # (K, C, 2M, Kp)
        pxy = pos[chain[:, None, None, None], pidx]    # (K, C, 2M, Kp, 2)
        pxy = torch.where((pidx == gi[..., None, None])[..., None],
                          xy_i[:, :, None, None], pxy)
        pxy = torch.where((swap[..., None, None]
                           & (pidx == gj[..., None, None]))[..., None],
                          xy_j[:, :, None, None], pxy)
        m = net_mask[affc] > 0
        px, py = pxy[..., 0], pxy[..., 1]
        nb = torch.stack([
            torch.where(m, px, big).amin(dim=-1),
            torch.where(m, px, -big).amax(dim=-1),
            torch.where(m, py, big).amin(dim=-1),
            torch.where(m, py, -big).amax(dim=-1),
        ], dim=-1)                                     # (K, C, 2M, 4)
        # padded slots scatter into the sink row n_nets; duplicate net ids
        # scatter identical boxes, so order is irrelevant
        row = torch.where(live, affc, n_nets)
        bbox2 = bbox[:, None].expand(k_, c_, n_nets + 1, 4).clone()
        bbox2[kc[..., None].expand_as(row), cc[..., None].expand_as(row),
              row] = nb
        cost2 = torch.sum(_eq2_terms(bbox2[:, :, :n_nets], occ2, gamma,
                                     alpha), dim=-1)   # (K, C)

        # ---- best-passing candidate per chain ---------------------------
        d = cost2 - cost[:, None]
        passed = valid & ((d <= 0) | (u < torch.exp(
            -d / torch.clamp(temps, min=1e-6)[:, None])))
        score = torch.where(passed, cost2, torch.inf)
        b = torch.argmin(score, dim=1)
        take = score[chain, b] < torch.inf

        def chosen(x):
            return x[chain, b]

        mi_b, tgt_b, src_b, jc_b = chosen(mi), chosen(tgt), chosen(src), \
            chosen(jc)
        swap_b, gi_b, gj_b = chosen(swap), chosen(gi), chosen(gj)
        xy_i_b, xy_j_b = chosen(xy_i), chosen(xy_j)
        slot2 = slot.clone()
        slot2[chain, mi_b] = tgt_b
        slot2[chain, torch.where(swap_b, jc_b, mi_b)] = torch.where(
            swap_b, src_b, tgt_b)
        owner2 = owner.clone()
        owner2[chain, src_b] = torch.where(swap_b, jc_b,
                                           torch.full_like(jc_b, -1))
        owner2[chain, tgt_b] = mi_b
        pos2 = pos.clone()
        pos2[chain, gi_b] = xy_i_b
        pos2[chain, torch.where(swap_b, gj_b, gi_b)] = torch.where(
            swap_b[:, None], xy_j_b, xy_i_b)
        slot = torch.where(take[:, None], slot2, slot)
        owner = torch.where(take[:, None], owner2, owner)
        pos = torch.where(take[:, None, None], pos2, pos)
        occ = torch.where(take[:, None, None], chosen(occ2), occ)
        bbox = torch.where(take[:, None, None], chosen(bbox2), bbox)
        cost = torch.where(take, chosen(cost2), cost)

        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_slot = torch.where(better[:, None], slot, best_slot)

        # ---- neighbour replica exchange --------------------------------
        # standard PT acceptance between ladder neighbours:
        # p = min(1, exp((E_a - E_b)(1/T_a - 1/T_b)))
        if t % exchange_every == exchange_every - 1:
            off = (t // exchange_every) % 2
            left = ((chain - off) % 2 == 0) & (chain + 1 < k_)
            partner = torch.clamp(chain + 1, max=k_ - 1)
            logp = ((cost - cost[partner])
                    * (1.0 / temps - 1.0 / temps[partner]))
            ue = torch.rand((k_,), generator=gen, device=dev)
            acc_left = left & (torch.log(torch.clamp(ue, min=1e-30)) < logp)
            right = torch.roll(acc_left, 1) & (chain > 0)
            perm = torch.where(acc_left, chain + 1,
                               torch.where(right, chain - 1, chain))
            slot, owner, pos, occ, bbox, cost, best_cost, best_slot = (
                x[perm] for x in (slot, owner, pos, occ, bbox, cost,
                                  best_cost, best_slot))
    return best_slot, best_cost


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

def batched_place(packed: PackedGraph,
                  placement: Dict[str, Tuple[int, int]],
                  width: int, height: int,
                  mem_columns: Sequence[int] = (),
                  io_ring: bool = True,
                  gamma: float = 0.3, alpha: float = 2.0,
                  n_steps: int = 300, n_chains: int = 16,
                  cands: int = DEFAULT_CANDS,
                  t0: float = 2.0, t_min: float = 0.01,
                  seed: int = 0,
                  exchange_every: int = DEFAULT_EXCHANGE_EVERY,
                  ladder: float = DEFAULT_LADDER,
                  return_cost: bool = False,
                  device: DeviceLike = None):
    """Anneal the legalized placement on ``device`` (``None``: the CUDA
    card): K parallel-tempering chains, best chain wins. Same contract as
    :func:`detailed_place.detailed_place` (only pe/mem instances move;
    legality is structural). Deterministic for a fixed ``seed``."""
    inst_order = list(packed.placeable)
    idx = {n: i for i, n in enumerate(inst_order)}
    members = _net_members(packed, idx)
    movable = [n for n in inst_order
               if packed.placeable[n].kind in ("pe", "mem")]
    if not members or not movable:
        return (dict(placement), 0.0) if return_cost else dict(placement)
    dev = resolve_device(device)

    n_nets = len(members)
    kp = max(len(m) for m in members)
    net_pins = np.zeros((n_nets, kp), np.int32)
    net_mask = np.zeros((n_nets, kp), np.int32)
    for n, mem in enumerate(members):
        net_pins[n, :len(mem)] = mem
        net_mask[n, :len(mem)] = 1

    mov_gid = np.array([idx[n] for n in movable], np.int32)
    touch: Dict[int, List[int]] = {i: [] for i in range(len(movable))}
    mov_of_gid = {int(g): i for i, g in enumerate(mov_gid)}
    for n, mem in enumerate(members):
        for gi in set(mem):
            if gi in mov_of_gid:
                touch[mov_of_gid[gi]].append(n)
    m_max = max(1, max(len(v) for v in touch.values()))
    mov_nets = np.full((len(movable), m_max), -1, np.int32)
    for i, nets_i in touch.items():
        mov_nets[i, :len(nets_i)] = nets_i

    slot_xy, inst_lo, inst_size, slot0 = _legal_slot_tables(
        packed, placement, movable, width, height, mem_columns, io_ring)
    owner0 = np.full(len(slot_xy), -1, np.int32)
    owner0[slot0] = np.arange(len(movable), dtype=np.int32)

    pos0 = np.array([placement[n] for n in inst_order], np.int32)
    occ0 = np.zeros((width, height), np.float32)
    for (x, y) in placement.values():
        occ0[x, y] = 1.0

    def t(a, dtype=torch.int64):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    # seed the chain state with the full per-net reduction — the
    # net_bboxes kernel on the padded (n_nets, K, 2) pin table
    pins0 = pos0[net_pins]
    bbox0 = ops.net_bboxes(t(pins0, torch.int32), t(net_mask, torch.int32))
    bbox0 = torch.cat([bbox0, torch.zeros((1, 4), dtype=torch.int32,
                                          device=dev)]).long()

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    best_slot, best_cost = _anneal(
        t(slot_xy), t(mov_gid), t(inst_lo), t(inst_size), t(net_pins),
        t(net_mask), t(mov_nets), t(pos0), t(occ0, torch.float32), t(slot0),
        t(owner0), bbox0, gen, float(gamma), float(alpha), float(t0),
        float(t_min), float(ladder), n_steps=int(n_steps),
        n_chains=int(n_chains), cands=int(cands),
        exchange_every=int(exchange_every))
    best_slot = best_slot.cpu().numpy()
    best_cost = best_cost.cpu().numpy()
    win = int(np.argmin(best_cost))

    out = {n: (int(x), int(y)) for n, (x, y) in placement.items()}
    for i, name in enumerate(movable):
        x, y = slot_xy[best_slot[win, i]]
        out[name] = (int(x), int(y))
    if return_cost:
        return out, float(best_cost[win])
    return out

"""The shared-memory plan of the thread-block cluster kernels.

The fused emulation kernels' cluster variant (``fabric_fused_batch`` /
``fabric_fused_run``) and the ready-valid sweeps (``rv_sweeps``) keep a
lane's node vector in the shared memory of a cluster of C blocks. Both
place the nodes in one order (:func:`order`), split the N + 1 slots (the
sentinel included) over the blocks in contiguous ranges, keep in each
block the records of the PE outputs among its slots (:func:`rooms`), and
fit a block into 227 KB. Each wrapper gives :func:`plan` its layout, a
block's bytes for C blocks and R records; ``csrc/cluster_launch.cuh``
launches both.
"""
from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from typing import Callable, Dict, Tuple

import torch

from . import build

#: cluster sizes, smallest first; past ``PORTABLE`` blocks a cluster is
#: non-portable, which an H100 schedules where a GPC has 16 free SMs
LADDER = (1, 2, 4, 8, 16)
PORTABLE = 8
#: shared memory one block may opt into on an H100 (227 KB)
BLOCK_SMEM_BYTES = 232_448

#: values computed once per table: a key of the tables' ids and the
#: question -> (weak references to the tables, their version counters,
#: the value); the DSE executor's emulation thread reads it too
_MEMO: dict = {}
_MEMO_LOCK = threading.Lock()


def memo(tables, question, compute):
    """``compute()``, kept while every tensor of ``tables`` lives and is
    not modified in place."""
    key = tuple(id(t) for t in tables) + question
    hit = _MEMO.get(key)
    if hit is not None and all(r() is t and v == t._version for r, v, t in
                               zip(hit[0], hit[1], tables)):
        return hit[2]
    value = compute()
    with _MEMO_LOCK:
        for k in [k for k, (refs, _, _) in _MEMO.items()
                  if any(r() is None for r in refs)]:
            del _MEMO[k]
        _MEMO[key] = ([weakref.ref(t) for t in tables],
                      [t._version for t in tables], value)
    return value


def order(src: torch.Tensor):
    """The cluster kernels' node order: ``node_of`` (N,) int32, the node
    in each slot, and ``slot_of`` (N + 1,) int32, its inverse with the
    sentinel N kept at slot N. Computed once per ``src`` tensor (a few
    small launches on its device) and kept while that tensor lives and
    is not modified in place.

    Each node goes beside the lowest-numbered node it may read, key
    ``min(i, src[i, :])``, ties in node order. Nodes read their own tile
    and its neighbours, and the IR numbers each kind of node (switch-box
    and port, register, register mux) tile by tile, so the key moves a
    tile's registers and muxes next to its switch box: the contiguous
    slot ranges of a cluster's blocks then hold rows of whole tiles. The
    order changes where values live, never what they are."""
    def compute():
        n = src.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=src.device)
        key = torch.minimum(idx, src.amin(1)) if src.shape[1] else idx
        node_of = torch.argsort(key, stable=True).to(torch.int32)
        slot_of = torch.empty(n + 1, dtype=torch.int32, device=src.device)
        slot_of[node_of.long()] = idx
        slot_of[n:] = n
        return node_of, slot_of
    return memo((src,), ("order",), compute)


def even_chunk(n, cluster):
    """Slots a block of ``cluster`` blocks holds: ceil((N + 1) / C)."""
    return -(-(n + 1) // cluster)


def rooms(src: torch.Tensor, held: torch.Tensor,
          chunk: Callable = even_chunk) -> Dict[int, int]:
    """A block's record room for each C of ``LADDER``: the most nodes of
    ``held`` ((N,) bool, the nodes that keep a record) whose :func:`order`
    slot falls in any one block's range of ``chunk(N, C)`` slots. On
    ``src``'s device in a few small launches and one read back."""
    n = src.shape[0]
    slot = order(src)[1][:n].long()[held]
    sizes = torch.tensor(LADDER, device=src.device)
    block = slot[None, :] // chunk(n, sizes)[:, None]        # (5, R)
    ranks = torch.arange(LADDER[-1], device=src.device)
    counts = (block[:, :, None] == ranks).sum(1)             # (5, 16)
    return dict(zip(LADDER, counts.amax(1).tolist()))


def plan(block_bytes: Callable[[int, int], int], rooms: Dict[int, int],
         card: Callable[[int, int], int]) -> Tuple[int, int]:
    """The cluster kernels' one size rule: ``(cluster, room)``, the
    smallest C of ``LADDER`` with ``block_bytes(C, rooms[C]) <=
    BLOCK_SMEM_BYTES``, or ``(0, 0)``. A non-portable C only where
    ``card(C, room)``, the clusters the card holds at once, is at least
    1; a portable C asks no card. Never a launch's outcome."""
    for c in LADDER:
        room = rooms[c]
        if block_bytes(c, room) <= BLOCK_SMEM_BYTES:
            if c > PORTABLE and card(c, room) < 1:
                break
            return c, room
    return 0, 0


@functools.lru_cache(maxsize=None)
def active_clusters(kernel: str, n: int, cluster: int, room: int,
                    pred: bool = False) -> int:
    """How many clusters of ``cluster`` blocks of ``kernel``
    (``"fabric_fused_batch"``, ``"fabric_fused_run"`` or ``"rv_sweeps"``)
    at N nodes and ``room`` PE records a block (for the fused kernels with
    the 1-bit inputs where ``pred``) the card holds at once
    (``cudaOccupancyMaxActiveClusters``); a launch of more queues the
    rest."""
    out = ctypes.c_int(0)
    lib = build.library()
    if kernel == "rv_sweeps":
        err = lib.canal_rv_sweeps_clusters(n, room, cluster,
                                           ctypes.byref(out))
    else:
        err = lib.canal_fabric_fused_clusters(
            int(kernel == "fabric_fused_run"), n, room, cluster, int(pred),
            ctypes.byref(out))
    build.check(err, kernel)
    return out.value

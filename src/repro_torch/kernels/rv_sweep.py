"""A ready-valid cycle's sweeps in one launch (``csrc/rv_sweeps.cu``).

``RVFabric`` settles a cycle with ``depth`` forward sweeps of data and
valid and ``depth`` backward sweeps of ready (``_rv_sweeps``). On the card
with ``use_kernels``, :func:`rv_sweeps` runs them all in one launch of
``canal_rv_sweeps``: three thread-block clusters, one for each vector, of
the blocks :func:`rv_plan` gives (``cluster_plan.plan``, the size rule the
fused kernels share). Where no cluster holds the fabric, ``RVFabric``
sweeps eagerly. The reference has no Pallas kernel here, so the kernel is
held to ``_rv_sweeps`` bit for bit.

:func:`rv_tables` resolves once a run what the configuration fixes, in
the kernel's node order (``cluster_plan.order``): every slot's forward and
backward descriptor and the PE cores' records, grouped by the block that
holds their outputs. :func:`rv_sweeps_plain` runs the same sweeps from
those tables in plain PyTorch; the wrapper takes it for CPU tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import build, cluster_plan
from .fabric_step import pe_alu_candidates

#: shared memory a block of ``canal_rv_sweeps`` keeps: for each node slot
#: 12 B in the data and valid clusters (two buffers and the descriptor) and
#: 16 B in the ready one (three buffers and the descriptor); for each PE
#: output among its slots a data record, 32 B (a valid record takes 16 B)
FWD_SLOT_BYTES = 12
BWD_SLOT_BYTES = 16
REC_BYTES = 32
#: a descriptor's fields (``csrc/rv_sweeps.cu``): the slot in its block,
#: the block's rank, a read of another block; forward: a pinned node, a PE
#: output or a constant operand; backward: no producer, a min that starts
#: at 1 (the node's consumer row has an unused slot)
SLOT_MASK = 0xFFFFF
RANK_SHIFT = 20
RANK_MASK = 0xF
REMOTE = 1 << 24
PIN = 1 << 25
SPECIAL = 1 << 26
NO_PUSH = 1 << 25
BASE1 = 1 << 26
#: a data record's op + 1 sits above its slot
OP_SHIFT = 24
INT32_MAX = 2 ** 31 - 1
Tables = Dict[str, object]


def rv_chunk(n, cluster):
    """Node slots a block of a cluster of ``cluster`` blocks holds: the
    N + 1 slots (the sentinel included) split evenly, rounded up to 4."""
    return (cluster_plan.even_chunk(n, cluster) + 3) & ~3


def rv_block_bytes(n: int, cluster: int, room: int) -> int:
    """A block's shared memory: the larger of the forward layout
    (``FWD_SLOT_BYTES`` a slot, ``REC_BYTES`` for each of ``room`` PE
    records) and the ready one (``BWD_SLOT_BYTES`` a slot), over
    :func:`rv_chunk` slots. At the Amber FULL size (N 86,288, 8 blocks)
    the ready layout's 172,608 B; at 8 blocks it holds N + 1 <= 116,224,
    at 16 blocks N + 1 <= 232,448."""
    chunk = rv_chunk(n, cluster)
    return max(FWD_SLOT_BYTES * chunk + REC_BYTES * room,
               BWD_SLOT_BYTES * chunk)


def rv_plan(src: torch.Tensor, pe_out: torch.Tensor) -> Tuple[int, int]:
    """``(cluster, room)`` for the kernel on a fabric of fan-in table
    ``src`` and PE outputs ``pe_out`` (a record each): ``cluster_plan``'s
    plan of :func:`rv_block_bytes` on the rooms counted in
    :func:`rv_chunk` slots (once per (``src``, ``pe_out``) while both
    live unmodified), asking the card before a non-portable cluster;
    ``(0, 0)`` where no cluster holds the fabric. Amber FULL takes 8
    blocks."""
    n = src.shape[0]

    def rooms():
        held = torch.zeros(n + 1, dtype=torch.bool, device=src.device)
        held[pe_out.long().reshape(-1)] = True
        return cluster_plan.rooms(src, held[:n], rv_chunk)

    return cluster_plan.plan(
        lambda c, room: rv_block_bytes(n, c, room),
        cluster_plan.memo((src, pe_out), ("rv_rooms",), rooms),
        lambda c, room: cluster_plan.active_clusters("rv_sweeps", n, c,
                                                     room))


def rv_tables(src: torch.Tensor, picked: torch.Tensor, keep: torch.Tensor,
              pin_ids: torch.Tensor, pe_in: torch.Tensor,
              pe_out: torch.Tensor, op: torch.Tensor, const: torch.Tensor,
              imm_mask: Optional[torch.Tensor],
              imm_val: Optional[torch.Tensor], cons_used: torch.Tensor,
              cluster: Optional[int] = None) -> Tables:
    """What a configuration fixes for the kernel, resolved once a run.

    src: (N, F) int32 fan-in table (it keys the node order); picked: (N,)
    each node's selected source (N: none); keep: (N,) bool, undriven
    nodes; pin_ids: (n_pin,) the pinned nodes in the pins' order; pe_in:
    (P, 4) the PE input nodes (sentinel N); pe_out: (P, K) the PE output
    nodes, K <= 2; op / const: (P,) the PE program, imm_mask / imm_val
    (P, 4) its immediates or None; cons_used: (N, C) each node's used
    consumers (sentinel N). ``cluster`` forces the blocks a cluster
    (default :func:`rv_plan`). All on ``src``'s device."""
    dev = src.device
    n, p = src.shape[0], pe_in.shape[0]
    if pe_out.dim() != 2 or pe_out.shape[1] > 2:
        raise ValueError("rv_sweeps: a PE has at most two outputs")
    c = rv_plan(src, pe_out)[0] if cluster is None else cluster
    if c not in cluster_plan.LADDER:
        raise ValueError(f"rv_sweeps: no cluster of {c or '1-16'} blocks "
                         f"holds N {n}, P {p}")
    chunk = rv_chunk(n, c)
    node_of, slot_of = cluster_plan.order(src)
    pos_of, node = slot_of.long(), node_of.long()
    positions = torch.arange(n, device=dev)

    def flag(mask: torch.Tensor, bit: int) -> torch.Tensor:
        return torch.where(mask, bit, 0)

    def locate(x: torch.Tensor, reader: torch.Tensor) -> torch.Tensor:
        """Node x (0..N) as its (rank, slot), read from slot ``reader``."""
        pos = pos_of[x]
        rank = pos // chunk
        return ((pos % chunk) | (rank << RANK_SHIFT)
                | flag(rank != reader // chunk, REMOTE))

    def ext(t: torch.Tensor, tail) -> torch.Tensor:
        return torch.cat([t, torch.full((1,), tail, dtype=t.dtype,
                                        device=dev)])

    pinned = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    pinned[pin_ids.long()] = True
    if bool(pinned[pe_in.long()].any()):
        raise ValueError("rv_sweeps: a PE input is a pinned node")
    held = pinned | ext(keep, False)
    picked_ext = ext(picked.long(), n)

    def gathered(u: torch.Tensor, reader: torch.Tensor) -> torch.Tensor:
        """The descriptor that reads node u's value after the gather and
        the hold from the previous vector; u == N (absent) is a constant.
        A pinned node reads itself: its pin, after sweep 0."""
        d = locate(torch.where(held[u], u, picked_ext[u]), reader)
        return torch.where(u == n, SPECIAL, d)

    pe_out_mask = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    pe_out_mask[pe_out.long().reshape(-1)] = True
    fwd = torch.where(pe_out_mask[node], SPECIAL,
                      gathered(node, positions) | flag(pinned[node], PIN))
    pin_index = torch.full((n,), -1, dtype=torch.int64, device=dev)
    pin_index[pin_ids.long()] = torch.arange(len(pin_ids), device=dev)

    # the PE records, one a PE output: op (-1 on the second output, which
    # passes a), const and the operands a, b, c (an immediate is a
    # constant operand)
    k_out = pe_out.shape[1]
    pe = torch.arange(p, device=dev).repeat_interleave(k_out)
    col = torch.arange(k_out, device=dev).repeat(p)
    out_pos = pos_of[pe_out.long().reshape(-1)]
    ins = pe_in.long()[pe]
    words = []
    for j in range(3):
        o = gathered(ins[:, j], out_pos)
        cst = torch.zeros_like(o)
        if imm_mask is not None:
            imm = imm_mask[pe, j] > 0
            o = torch.where(imm, SPECIAL, o)
            cst = torch.where(imm, imm_val[pe, j].long(), 0)
        words += [o, cst]
    ops = torch.where(col == 0, op.long()[pe], -1)
    rank = out_pos // chunk
    head = (out_pos % chunk) | ((ops + 1) << OP_SHIFT)
    rec_d = torch.stack([head, const.long()[pe]] + words, 1)
    rec_v = torch.stack([out_pos % chunk, gathered(ins[:, 0], out_pos),
                         gathered(ins[:, 1], out_pos), torch.zeros_like(col)],
                        1)
    order = torch.argsort(rank, stable=True)
    counts = torch.bincount(rank, minlength=c)
    rec_off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    room = int(counts.max())
    if rv_block_bytes(n, c, room) > cluster_plan.BLOCK_SMEM_BYTES:
        raise ValueError(f"rv_sweeps: no cluster of {c} blocks holds N {n}, "
                         f"P {p}")

    prod = picked.long()[node]
    no_push = prod >= n
    bwd = (locate(torch.clamp(prod, max=n), positions)
           | flag(no_push, NO_PUSH)
           | flag((cons_used == n).any(1)[node], BASE1))

    def i32(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.int32).contiguous()

    return {"node_of": i32(node_of), "fwd": i32(fwd),
            "pin_of": i32(pin_index[node]), "bwd": i32(bwd),
            "rec_d": i32(rec_d[order]), "rec_v": i32(rec_v[order]),
            "rec_off": i32(rec_off), "n": n, "cluster": c, "room": room,
            "chunk": chunk}


# ----------------------------------------------------------- plain version
def _where(t: torch.Tensor, tables: Tables) -> torch.Tensor:
    """The slot position that descriptors ``t`` locate."""
    t = t.long()
    return ((t >> RANK_SHIFT) & RANK_MASK) * tables["chunk"] + (t & SLOT_MASK)


def _has(t: torch.Tensor, bit: int) -> torch.Tensor:
    return (t.long() & bit) != 0


def _forward_plain(tables: Tables, buf: Sequence[torch.Tensor],
                   pins: torch.Tensor, depth: int, word: int,
                   valid: bool) -> None:
    n = tables["n"]
    node = tables["node_of"].long()
    vals = [torch.zeros(tables["cluster"] * tables["chunk"],
                        dtype=torch.int32, device=node.device)
            for _ in range(2)]
    vals[0][:n] = buf[0][node]
    if len(pins):
        pin_of = tables["pin_of"].long()
        vals[1][:n] = torch.where(pin_of >= 0, pins[pin_of.clamp(min=0)], 0)
    fwd = tables["fwd"]
    src, special, pin = _where(fwd, tables), _has(fwd, SPECIAL), \
        _has(fwd, PIN)
    rec = tables["rec_v" if valid else "rec_d"].long()
    rank = torch.searchsorted(tables["rec_off"][1:].long(),
                              torch.arange(len(rec), device=node.device),
                              right=True)
    out_pos = rank * tables["chunk"] + (rec[:, 0] & SLOT_MASK)
    for t in range(depth):
        cur, nxt = vals[t % 2], vals[(t + 1) % 2]

        def operand(o: torch.Tensor, c) -> torch.Tensor:
            return torch.where(_has(o, SPECIAL), c, cur[_where(o, tables)])

        if valid:
            res = torch.minimum(operand(rec[:, 1], 1), operand(rec[:, 2], 1))
        else:
            a, b, c = (operand(rec[:, 2 * j + 2], rec[:, 2 * j + 3])
                       for j in range(3))
            op = (rec[:, 0] >> OP_SHIFT) - 1
            op = torch.where((op >= 0) & (op < 13), op, 13)   # 13: pass
            cand = pe_alu_candidates(a.to(torch.int32), b.to(torch.int32),
                                     c.to(torch.int32),
                                     rec[:, 1].to(torch.int32))
            res = torch.gather(cand, 0, op[None])[0] & word
        copy = ~special & ~(pin & (t == 0))
        nxt[:n] = torch.where(copy, cur[src], nxt[:n])
        nxt[out_pos] = res.to(torch.int32)
    buf[0][node] = vals[0][:n]
    buf[1][node] = vals[1][:n]


def _backward_plain(tables: Tables, buf: Sequence[torch.Tensor],
                    fix_mask: torch.Tensor, fix_val: torch.Tensor,
                    depth: int) -> None:
    n = tables["n"]
    node = tables["node_of"].long()
    bwd = tables["bwd"]
    fixed, val = fix_mask[node], fix_val[node]
    # a node pushes into its producer, unless it has none (the sentinel's
    # slot N) or its producer is fixed; what it does not push goes to a
    # spare slot N
    prod = _where(bwd, tables)
    push = ~_has(bwd, NO_PUSH) & ~torch.cat([fixed, fixed.new_zeros(1)])[prod]
    to = torch.where(push, prod, n)
    start = torch.where(_has(bwd, BASE1), 1, INT32_MAX).to(torch.int32)
    start = torch.cat([start, start.new_full((1,), INT32_MAX)])
    before, cur = None, buf[0][node]
    for _ in range(depth):
        joined = start.scatter_reduce(0, to, torch.where(push, cur,
                                                         INT32_MAX), "amin")
        before, cur = cur, torch.where(fixed, val, joined[:n])
    buf[depth % 2][node] = cur
    buf[(depth + 1) % 2][node] = before


def rv_sweeps_plain(tables: Tables, d: Sequence[torch.Tensor],
                    v: Sequence[torch.Tensor], r: Sequence[torch.Tensor],
                    pins_d: torch.Tensor, pins_v: torch.Tensor,
                    fix_mask: torch.Tensor, fix_val: torch.Tensor,
                    depth: int, word: int = 0xFFFF) -> None:
    """Plain PyTorch version of :func:`rv_sweeps`: the kernel's sweeps
    from its own tables, in its slot order."""
    if depth <= 0:
        return
    _forward_plain(tables, d, pins_d, depth, word, valid=False)
    _forward_plain(tables, v, pins_v, depth, word, valid=True)
    _backward_plain(tables, r, fix_mask, fix_val, depth)


# ----------------------------------------------------------------- wrapper
def rv_sweeps(tables: Tables, d: Sequence[torch.Tensor],
              v: Sequence[torch.Tensor], r: Sequence[torch.Tensor],
              pins_d: torch.Tensor, pins_v: torch.Tensor,
              fix_mask: torch.Tensor, fix_val: torch.Tensor, depth: int,
              word: int = 0xFFFF) -> None:
    """One ready-valid cycle's ``depth`` forward and ``depth`` backward
    sweeps, in place on its buffers, as ``RVFabric._rv_sweeps`` leaves
    them: d = (data 0, data 1), each (N + 1,) int32; v = (valid 0, valid
    1), (N + 2,); r = (ready 0, ready 1), (N + 1,); pins_d / pins_v
    (n_pin,) int32; fix_mask (N,) bool, fix_val (N,) int32; ``tables``
    from :func:`rv_tables` on the same device. Depth 0 does nothing.

    A call captured into a CUDA graph counts no launch: whoever replays
    the graph counts its launches."""
    if depth <= 0:
        return
    dev = d[0].device
    if dev.type == "cpu":
        rv_sweeps_plain(tables, d, v, r, pins_d, pins_v, fix_mask, fix_val,
                        depth, word)
        return
    kernel = "rv_sweeps"
    n = tables["n"]
    build.require(kernel, dev, torch.int32, d0=d[0], d1=d[1], v0=v[0],
                  v1=v[1], r0=r[0], r1=r[1], pins_d=pins_d, pins_v=pins_v,
                  fix_val=fix_val)
    build.require(kernel, dev, torch.bool, fix_mask=fix_mask)
    for name, t, length in (("d", d, n + 1), ("v", v, n + 2),
                            ("r", r, n + 1)):
        for k in (0, 1):
            build.require_shape(kernel, f"{name}{k}", t[k], (length,))
    for name, t in (("fix_mask", fix_mask), ("fix_val", fix_val)):
        build.require_shape(kernel, name, t, (n,))
    ptr = {k: tables[k].data_ptr() for k in ("node_of", "fwd", "pin_of",
                                             "bwd", "rec_d", "rec_v",
                                             "rec_off")}
    err = build.library().canal_rv_sweeps(
        ptr["node_of"], ptr["fwd"], ptr["pin_of"], ptr["bwd"], ptr["rec_d"],
        ptr["rec_v"], ptr["rec_off"], pins_d.data_ptr(), pins_v.data_ptr(),
        fix_mask.data_ptr(), fix_val.data_ptr(), d[0].data_ptr(),
        d[1].data_ptr(), v[0].data_ptr(), v[1].data_ptr(), r[0].data_ptr(),
        r[1].data_ptr(), n, tables["room"], int(depth), int(word),
        tables["cluster"], build.stream_ptr(dev))
    build.check(err, kernel)
    if not torch.cuda.is_current_stream_capturing():
        build.count_launch(kernel)

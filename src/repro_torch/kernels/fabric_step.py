"""Fabric sweep kernels (counterpart of repro/kernels/fabric_step.py).

Four kernels, all hand-written CUDA:

``fabric_sweep`` / ``fabric_sweep_batch`` (``csrc/fabric_sweep.cu``)
    One combinational sweep, ``out[i] = vals[src[i, sel[i]]]``, for one
    configuration or for B configurations over one shared ``src`` table:
    the single-config ``step``/``run`` path, the unfused ``step_batch``
    baseline and the chunked configuration sweep of ``core/verify.py``.

``fabric_fused_batch`` (``csrc/fabric_step.cu``)
    The whole per-cycle fixpoint for B configurations in one launch:
    ``max_depth`` sweeps of gather -> hold undriven (``keep``) -> re-pin
    (``pin_mask`` / ``pin_vals``) -> PE ALU (14 ops, 19 for PEs with the
    1-bit inputs) masked by ``word`` -> PE results placed through
    ``pe_res_idx``; lane b runs exactly ``min(depths[b], max_depth)``
    sweeps.

``fabric_fused_run`` (``csrc/fabric_step.cu``)
    T fabric cycles in one launch. Each lane's state vector is laid out
    ``[regs | io | mem | 0]``; every cycle starts from the pinned sources
    on a zero background, runs the fused fixpoint, observes ``io_out`` and
    clocks registers (``reg_src``) and memories (``mem_in``).

The two fused kernels come in two variants, chosen by
:func:`fused_plan` from N, the PE layout and how many PE outputs each
block's slots hold (:func:`fused_rooms`), by the plan ``rv_sweeps`` shares
(``cluster_plan``): one thread block cluster of 1-16 blocks per lane with
the lane's vector in the cluster's shared memory, or, for fabrics too
large for that, one cooperative grid over value vectors in device memory.

Each wrapper takes the plain PyTorch version beside it only when its
tensors lie on the CPU; CUDA tensors launch the kernel (or raise).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.obs import span

from . import build, cluster_plan
from .cluster_plan import BLOCK_SMEM_BYTES

# PE ALU candidate order; must match repro_torch.core.tiles.PECore.OPS
# (repro_torch.core.lowering asserts the correspondence at import time).
PE_OPS = ("add", "sub", "mul", "and", "or", "xor", "shl", "shr", "min",
          "max", "abs", "sel", "const", "pass")
#: the predicate PE's further ops (``PECore.PRED_OPS``), ids 14-18: they
#: read the 1-bit inputs, which only a fabric with a 1-bit layer has
PRED_OPS = ("ugt", "uge", "ult", "psel", "pand")
#: columns of ``pe_in``: data0-3, and on a fabric with a 1-bit layer also
#: bit0-2 (the PE then has a third output, res_p)
PE_INPUTS = 4
PRED_PE_INPUTS = 7

#: what the fused kernels' cluster variant keeps in a block's shared
#: memory (``cluster_plan``): for each node slot two value buffers, the
#: pinned value and the node's descriptor, 4 B each; for each PE output
#: among the block's slots its record, 32 B (48 B on a fabric with a 1-bit
#: layer: the bit operands and the result's mask too); the records' count
SLOT_BYTES = 16
REC_BYTES = 32
PRED_REC_BYTES = 48
COUNT_BYTES = 16
#: an H100's SMs, and the threads each holds at once
SM_COUNT = 132
SM_THREADS = 2048
#: ``fabric_sweep``'s consecutive nodes a thread (the kernel's kNodes) and
#: its threads a block, at most and at least; see sweep_tiles
SWEEP_NODES = 4
SWEEP_THREADS = 256
SWEEP_MIN_THREADS = 64
#: ``fabric_sweep_batch``'s node tile (4 nodes a thread) and the least it
#: halves to for more blocks, its configuration lanes a block and largest
#: configuration group, and the blocks it keeps in its grid where B and N
#: allow (two for each of an H100's 132 SMs); see sweep_batch_tiles
SWEEP_TILE = 256
SWEEP_FILL_TILE = 128
SWEEP_LANES = 4
SWEEP_GROUP = 16
SWEEP_MIN_BLOCKS = 2 * SM_COUNT
MAX_GRID_Y = 65535


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def pe_alu_candidates(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      const: torch.Tensor, bits=None) -> torch.Tensor:
    """All PE ALU results, stacked (n_ops, ...) in ``PE_OPS`` order, with
    the reference's int32 semantics: add/sub/mul/shl/abs wrap, ``>>`` is
    arithmetic and the shift amount clips to [0, 15]. Wrapping ops are
    computed in int64 and wrapped explicitly (int32 overflow is not
    defined behaviour in PyTorch's C++ kernels).

    ``bits`` (the PE's bit0 and bit1 inputs) appends the ``PRED_OPS``:
    a >, >= and < b compared as unsigned 32-bit words (0 or 1), ``bit0 ?
    a : b`` and ``bit0 & bit1`` (both on the inputs' low bits)."""
    a64, b64 = a.long(), b.long()
    shift = torch.clamp(b, 0, 15)
    rows = [
        _wrap32(a64 + b64), _wrap32(a64 - b64), _wrap32(a64 * b64),
        a & b, a | b, a ^ b,
        _wrap32(a64 << shift.long()), a >> shift,
        torch.minimum(a, b), torch.maximum(a, b),
        _wrap32(torch.abs(_wrap32(a64 - b64).long())),
        torch.where((a & 1) == 1, b, c), const, a,
    ]
    if bits is not None:
        p0, p1 = bits
        ua, ub = a64 & 0xFFFFFFFF, b64 & 0xFFFFFFFF
        rows += [(ua > ub).to(a.dtype), (ua >= ub).to(a.dtype),
                 (ua < ub).to(a.dtype), torch.where((p0 & 1) == 1, a, b),
                 p0 & p1 & 1]
    return torch.stack(rows, dim=0)


def pe_outputs(pe_in: torch.Tensor) -> int:
    """A PE's outputs for ``pe_in``'s layout: res0 and res1, and res_p
    where the PE has the 1-bit inputs (``PRED_PE_INPUTS`` columns)."""
    return 3 if pe_in.shape[-1] == PRED_PE_INPUTS else 2


def pe_results(ins: torch.Tensor, imm_mask: Optional[torch.Tensor],
               imm_val: Optional[torch.Tensor], op: torch.Tensor,
               const: torch.Tensor, word: int):
    """(B, P, K) gathered PE inputs (``pe_in``'s columns) -> the (B, P)
    results of each output: the ALU result masked to ``word`` (res0),
    data0 passed through (res1) and, for a PE with the 1-bit inputs, the
    result's low bit (res_p). Immediates (``imm_mask`` > 0) replace data
    inputs only."""
    data = ins[..., :PE_INPUTS]
    if imm_mask is not None:
        data = torch.where(imm_mask > 0, imm_val, data)
    a, b, c = data[..., 0], data[..., 1], data[..., 2]
    pred = pe_outputs(ins) == 3
    bits = (ins[..., 4], ins[..., 5]) if pred else None
    cand = pe_alu_candidates(a, b, c, const, bits)
    res = torch.gather(cand, 0, op.long()[None])[0]
    return [res & word, a & word] + ([res & 1] if pred else [])


# ----------------------------------------------------------- plain versions
def _picked(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """(B, N) selected source node per lane and node: src[i, sel[b, i]]."""
    n, f = src.shape
    rows = torch.arange(n, device=src.device) * f
    return src.reshape(-1)[rows[None, :] + sel.long()]


def _span(t: torch.Tensor):
    """The bytes [start, end) of memory that ``t`` can reach."""
    if t.numel() == 0:
        return t.data_ptr(), t.data_ptr()
    last = sum((size - 1) * stride for size, stride in zip(t.shape,
                                                           t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def _sweep_out(kernel: str, vals_ext: torch.Tensor, n: int,
               out: Optional[torch.Tensor]) -> torch.Tensor:
    """``out`` checked as a sweep's destination (a contiguous int32 (N,)
    tensor on ``vals_ext``'s device, apart from ``vals_ext``), or a new
    one."""
    if out is None:
        return torch.empty(n, dtype=torch.int32, device=vals_ext.device)
    build.require(kernel, vals_ext.device, torch.int32, out=out)
    build.require_shape(kernel, "out", out, (n,))
    (o0, o1), (v0, v1) = _span(out), _span(vals_ext)
    if o0 < v1 and v0 < o1:
        raise ValueError(f"{kernel}: out overlaps vals_ext")
    return out


def fabric_sweep_plain(vals_ext: torch.Tensor, src: torch.Tensor,
                       sel: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fabric_sweep`."""
    out = _sweep_out("fabric_sweep", vals_ext, sel.shape[0], out)
    return torch.index_select(vals_ext, 0, _picked(src, sel[None])[0],
                              out=out)


def fabric_sweep_batch_plain(vals_ext: torch.Tensor, src: torch.Tensor,
                             sel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fabric_sweep_batch`."""
    return torch.gather(vals_ext, 1, _picked(src, sel).long())


def _plain_fixpoint(vals0, pin_vals, picked, depths, op, const, imm_mask,
                    imm_val, keep, pin_mask, pe_in, pe_res_idx,
                    max_depth: int, word: int) -> torch.Tensor:
    """Masked Jacobi sweeps of the fused engine; returns (B, N)."""
    b, n = vals0.shape
    p, k_in = pe_in.shape
    outs = pe_outputs(pe_in)
    zero = torch.zeros((b, 1), dtype=torch.int32, device=vals0.device)
    v = torch.cat([vals0, zero], dim=1)                   # (B, N+1)
    keep_b = (keep > 0)[None, :]
    pin_b = (pin_mask > 0)[None, :]
    is_pe = (pe_res_idx < outs * p)[None, :]
    pe_flat = pe_in.reshape(-1).long()
    res_idx = pe_res_idx.long()
    depths = depths.to(vals0.device)
    for t in range(max_depth):
        nv = torch.gather(v, 1, picked)
        nv = torch.where(keep_b, v[:, :n], nv)
        nv = torch.where(pin_b, pin_vals, nv)
        ins = torch.cat([nv, zero], dim=1)[:, pe_flat].reshape(b, p, k_in)
        res = torch.stack(pe_results(ins, imm_mask, imm_val, op, const,
                                     word), dim=2)
        res = torch.cat([res.reshape(b, outs * p), zero], dim=1)
        nv = torch.where(is_pe, res[:, res_idx], nv)
        live = (t < depths)[:, None]
        v = torch.cat([torch.where(live, nv, v[:, :n]), zero], dim=1)
    return v[:, :n]


def fabric_fused_batch_plain(vals0, sel, pin_vals, depths, op, const,
                             imm_mask, imm_val, src, keep, pin_mask, pe_in,
                             pe_res_idx, max_depth: int,
                             word: int = 0xFFFF) -> torch.Tensor:
    """Plain PyTorch version of :func:`fabric_fused_batch`."""
    return _plain_fixpoint(vals0, pin_vals, _picked(src, sel), depths, op,
                           const, imm_mask, imm_val, keep, pin_mask, pe_in,
                           pe_res_idx, max_depth, word)


def fabric_fused_run_plain(sel, ext, depths, op, const, imm_mask, imm_val,
                           src, keep, pin_mask, pin_src, pe_in, pe_res_idx,
                           reg_src, mem_in, io_out, n_reg: int, n_io: int,
                           n_mem: int, max_depth: int, chunk: int = 8,
                           word: int = 0xFFFF) -> torch.Tensor:
    """Plain PyTorch version of :func:`fabric_fused_run` (a loop over the
    T cycles; ``chunk`` does not change the result)."""
    b, n = sel.shape
    t_len = ext.shape[1]
    dev = sel.device
    picked = _picked(src, sel)
    zero = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    st = torch.zeros((b, n_reg + n_io + n_mem + 1), dtype=torch.int32,
                     device=dev)
    obs = torch.zeros((b, t_len, n_io), dtype=torch.int32, device=dev)
    pin_b = (pin_mask > 0)[None, :]
    pin_src = pin_src.long()
    for c in range(t_len):
        st[:, n_reg:n_reg + n_io] = ext[:, c, :n_io]
        pinned = st[:, pin_src]
        v0 = torch.where(pin_b, pinned, torch.zeros_like(pinned))
        v = _plain_fixpoint(v0, pinned, picked, depths, op, const, imm_mask,
                            imm_val, keep, pin_mask, pe_in, pe_res_idx,
                            max_depth, word)
        v_ext = torch.cat([v, zero], dim=1)
        obs[:, c] = v_ext[:, io_out.long()]
        st[:, :n_reg] = v_ext[:, reg_src.long()]
        st[:, n_reg + n_io:n_reg + n_io + n_mem] = v_ext[:, mem_in.long()]
    return obs


# ----------------------------------------------------------------- wrappers
def _check_sweep(kernel, vals_ext, src, sel, sel_shape):
    build.require(kernel, vals_ext.device, torch.int32, vals_ext=vals_ext,
                  src=src, sel=sel)
    if src.dim() != 2:
        raise ValueError(f"{kernel}: src has shape {tuple(src.shape)}, "
                         f"expected (N, F)")
    build.require_shape(kernel, "sel", sel, sel_shape)
    if max(vals_ext.shape + sel.shape + src.shape, default=0) >= 2 ** 31:
        raise ValueError(f"{kernel}: a dimension overflows the kernel's "
                         f"int32 arguments")


def fabric_sweep(vals_ext: torch.Tensor, src: torch.Tensor,
                 sel: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sweep of one configuration. vals_ext: (V,) int32 values, the
    zero sentinel at N (V = N + 1 on the fabric); src: (N, F) int32 with
    entries in [0, V); sel: (N,) int32 in [0, F). Returns (N,) int32
    ``vals_ext[src[i, sel[i]]]``, written into ``out`` when it is given
    (a contiguous int32 (N,) tensor on the same device that does not
    overlap ``vals_ext``).

    A call captured into a CUDA graph launches nothing and counts
    nothing: whoever replays the graph counts its launches."""
    if vals_ext.device.type == "cpu":
        return fabric_sweep_plain(vals_ext, src, sel, out)
    kernel = "fabric_sweep"
    n, f = src.shape if src.dim() == 2 else (-1, -1)
    _check_sweep(kernel, vals_ext, src, sel, (n,))
    if vals_ext.dim() != 1:
        raise ValueError(f"{kernel}: vals_ext must be 1-D, got "
                         f"{tuple(vals_ext.shape)}")
    out = _sweep_out(kernel, vals_ext, n, out)
    if n == 0:
        return out
    align = 4 * SWEEP_NODES
    aligned = sel.data_ptr() % align == 0 and out.data_ptr() % align == 0
    err = build.library().canal_fabric_sweep(
        vals_ext.data_ptr(), src.data_ptr(), sel.data_ptr(), out.data_ptr(),
        n, f, *sweep_tiles(n), int(aligned),
        build.stream_ptr(vals_ext.device))
    build.check(err, kernel)
    if not torch.cuda.is_current_stream_capturing():
        build.count_launch(kernel)
    return out


def sweep_tiles(n: int):
    """``fabric_sweep``'s size rule: ``(blocks, threads)``.

    Thread t of the grid's S = blocks x threads takes node groups t, t +
    S, ... of ``SWEEP_NODES`` consecutive nodes, then the N % 4 tail nodes
    t, t + S, ... one at a time (all nodes one at a time where sel or out
    is not 16-B aligned). The grid is one wave: threads start at
    ``SWEEP_THREADS`` and halve, not below ``SWEEP_MIN_THREADS``, while
    fewer blocks than ``SM_COUNT`` would cover the groups; blocks are as
    many as cover them, at most as many as the card holds at once
    (``SM_COUNT x SM_THREADS / threads``), past which threads stride. The
    rule reads N only."""
    work = max(1, -(-n // SWEEP_NODES))
    threads = SWEEP_THREADS
    while threads > SWEEP_MIN_THREADS and -(-work // threads) < SM_COUNT:
        threads //= 2
    return min(-(-work // threads), SM_COUNT * SM_THREADS // threads), threads


def sweep_batch_tiles(b: int, n: int, f: int):
    """``fabric_sweep_batch``'s size rule: ``(TN, lanes, BB, grid_y,
    smem)``.

    A block owns a tile of TN nodes and groups of BB configurations
    (blocks ``y``, ``y + grid_y``, ...); its TN / 4 x ``lanes`` threads
    each take 4 nodes of the tile for every ``lanes``-th configuration
    of a group. It stages the tile's src rows in ``smem`` bytes of shared
    memory, 4 B a word with rows padded to an odd length: ``4 TN (F |
    1)``. TN starts at ``SWEEP_TILE`` and halves (down to 4) until the
    tile fits ``BLOCK_SMEM_BYTES``; a fan-in too wide for 4 nodes raises
    ValueError. Above ``SWEEP_FILL_TILE``, TN halves while half of it
    still covers N. BB starts at ``SWEEP_GROUP`` (at most B) and halves,
    then TN halves (not below ``SWEEP_FILL_TILE``), while the grid has
    fewer than ``SWEEP_MIN_BLOCKS`` blocks; lanes is ``SWEEP_LANES``, at
    most BB. The rule reads B, N and F only."""
    ld = f | 1
    tn = SWEEP_TILE
    while tn > 4 and 4 * tn * ld > BLOCK_SMEM_BYTES:
        tn //= 2
    if 4 * tn * ld > BLOCK_SMEM_BYTES:
        raise ValueError(f"fabric_sweep_batch: fan-in {f} leaves no room "
                         f"for a tile of 4 nodes in shared memory")

    def blocks(tn, bb):
        return -(-n // tn) * -(-b // bb)

    while tn > SWEEP_FILL_TILE and tn // 2 >= n:
        tn //= 2
    bb = max(1, min(SWEEP_GROUP, b))
    while bb > 1 and blocks(tn, bb) < SWEEP_MIN_BLOCKS:
        bb = -(-bb // 2)
    while tn > SWEEP_FILL_TILE and blocks(tn, bb) < SWEEP_MIN_BLOCKS:
        tn //= 2
    grid_y = min(-(-b // bb), MAX_GRID_Y)
    return tn, min(SWEEP_LANES, bb), bb, grid_y, 4 * tn * ld


def fabric_sweep_batch(vals_ext: torch.Tensor, src: torch.Tensor,
                       sel: torch.Tensor) -> torch.Tensor:
    """One sweep of B configurations over a shared fan-in table.
    vals_ext: (B, V) int32 (sentinel column N); src: (N, F) int32 with
    entries in [0, V); sel: (B, N) int32 in [0, F). Returns (B, N) int32
    ``vals_ext[b, src[i, sel[b, i]]]``."""
    if vals_ext.device.type == "cpu":
        return fabric_sweep_batch_plain(vals_ext, src, sel)
    kernel = "fabric_sweep_batch"
    if vals_ext.dim() != 2:
        raise ValueError(f"{kernel}: vals_ext must be (B, V), got "
                         f"{tuple(vals_ext.shape)}")
    b, v_len = vals_ext.shape
    n, f = src.shape if src.dim() == 2 else (-1, -1)
    _check_sweep(kernel, vals_ext, src, sel, (b, n))
    out = torch.empty((b, n), dtype=torch.int32, device=vals_ext.device)
    if b == 0 or n == 0:
        return out
    tiles = sweep_batch_tiles(b, n, f)
    aligned = all(t.data_ptr() % 16 == 0 for t in (src, sel, out))
    err = build.library().canal_fabric_sweep_batch(
        vals_ext.data_ptr(), src.data_ptr(), sel.data_ptr(), out.data_ptr(),
        b, n, f, v_len, *tiles, int(aligned),
        build.stream_ptr(vals_ext.device))
    build.check(err, kernel)
    build.count_launch(kernel)
    return out


def _check_fabric(kernel, b, n, p, depths, sel, op, const, imm_mask,
                  imm_val, src, keep, pin_mask, pe_in, pe_res_idx, **lane_nb):
    dev = sel.device
    build.require(kernel, dev, torch.int32, depths=depths, sel=sel, op=op,
                  const=const, imm_mask=imm_mask, imm_val=imm_val, src=src,
                  keep=keep, pin_mask=pin_mask, pe_in=pe_in,
                  pe_res_idx=pe_res_idx, **lane_nb)
    for name, t, shape in [("depths", depths, (b,)), ("sel", sel, (b, n)),
                           ("op", op, (b, p)), ("const", const, (b, p)),
                           ("imm_mask", imm_mask, (b, p, 4)),
                           ("imm_val", imm_val, (b, p, 4)),
                           ("keep", keep, (n,)), ("pin_mask", pin_mask, (n,)),
                           ("pe_res_idx", pe_res_idx, (n,))]:
        build.require_shape(kernel, name, t, shape)
    if pe_in.dim() != 2 or pe_in.shape[0] != p or pe_in.shape[1] not in (
            PE_INPUTS, PRED_PE_INPUTS):
        raise ValueError(f"{kernel}: pe_in has shape {tuple(pe_in.shape)}, "
                         f"expected ({p}, {PE_INPUTS}) or "
                         f"({p}, {PRED_PE_INPUTS})")
    if src.dim() != 2 or src.shape[0] != n:
        raise ValueError(f"{kernel}: src has shape {tuple(src.shape)}, "
                         f"expected ({n}, F)")
    if 2 * b * (n + 1) >= 2 ** 31:
        raise ValueError(f"{kernel}: {b} lanes x {n} nodes overflow the "
                         f"kernel's int32 indexing")


def fused_block_bytes(n: int, cluster: int, room: int,
                      pred: bool = False) -> int:
    """A block's shared memory in the cluster variant: ``SLOT_BYTES`` for
    each of its ceil((N + 1) / C) slots, ``REC_BYTES`` for each of its
    ``room`` PE records (``PRED_REC_BYTES`` where ``pred``: PEs with the
    1-bit inputs) and ``COUNT_BYTES``: at the Amber FULL size (N 86,288,
    8 blocks, room 208) 179,264 B; on the two-layer array (N 179,312, 16
    blocks, room 208, the 1-bit inputs) 189,328 B."""
    rec = PRED_REC_BYTES if pred else REC_BYTES
    return SLOT_BYTES * cluster_plan.even_chunk(n, cluster) + rec * room \
        + COUNT_BYTES


def fused_rooms(src: torch.Tensor, pe_res_idx: torch.Tensor,
                n_res: int) -> Dict[int, int]:
    """The cluster variant's record rooms (``cluster_plan.rooms``): a
    record for each PE-output node (``pe_res_idx < n_res``, n_res = 2P,
    or 3P with the 1-bit inputs). Counted once per (``src``,
    ``pe_res_idx``) while both live unmodified."""
    return cluster_plan.memo(
        (src, pe_res_idx), ("rooms", n_res),
        lambda: cluster_plan.rooms(src, pe_res_idx < n_res))


def fused_plan(kernel: str, src: torch.Tensor, pe_res_idx: torch.Tensor,
               pe_in: torch.Tensor) -> Tuple[int, int]:
    """The fused ``kernel``'s variant for these tables on the card:
    ``(cluster, room)``, ``cluster_plan.plan`` of the cluster variant's
    layout (:func:`fused_block_bytes`) on the order's :func:`fused_rooms`,
    asking the card (``cluster_plan.active_clusters``) before a
    non-portable cluster; ``(0, 0)`` for the global-memory variant."""
    n, p = src.shape[0], pe_in.shape[0]
    outs = pe_outputs(pe_in)
    pred = outs == 3
    return cluster_plan.plan(
        lambda c, room: fused_block_bytes(n, c, room, pred),
        fused_rooms(src, pe_res_idx, outs * p),
        lambda c, room: cluster_plan.active_clusters(kernel, n, c, room,
                                                     pred))


def _fused_scratch(kernel, src, b, pred, cluster, room, state_words=0):
    """Device tables of the variant ``cluster`` selects: the cluster
    variant's node order (``cluster_plan.order`` of ``src``); the global
    variant's value buffers and picked sources (and, for the run kernel,
    pinned values and the state). Raises when no cluster of that size
    and ``room`` fits the card."""
    dev = src.device
    n = src.shape[0]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    if cluster:
        if cluster_plan.active_clusters(kernel, n, cluster, room, pred) < 1:
            raise RuntimeError(f"{kernel}: no cluster of {cluster} blocks "
                               f"at N {n}, room {room} fits this card")
        return dict(zip(("node_of", "slot_of"), cluster_plan.order(src)))
    out = {"buf": empty(2 * b * (n + 1)), "picked": empty(b, n)}
    if state_words:
        out.update(pinv=empty(b, n), state=empty(b, state_words))
    return out


def _ptr(scratch, name):
    t = scratch.get(name)
    return None if t is None else t.data_ptr()


def fabric_fused_batch(vals0: torch.Tensor, sel: torch.Tensor,
                       pin_vals: torch.Tensor, depths: torch.Tensor,
                       op: torch.Tensor, const: torch.Tensor,
                       imm_mask: torch.Tensor, imm_val: torch.Tensor,
                       src: torch.Tensor, keep: torch.Tensor,
                       pin_mask: torch.Tensor, pe_in: torch.Tensor,
                       pe_res_idx: torch.Tensor, max_depth: int,
                       word: int = 0xFFFF) -> torch.Tensor:
    """Fused batched fixpoint. vals0/sel/pin_vals: (B, N) int32; depths:
    (B,) per-lane sweep counts; op/const: (B, P); imm_mask/imm_val:
    (B, P, 4); src: (N, F) with sentinel N for absent fan-in; keep /
    pin_mask: (N,) flags; pe_in: (P, 4) node ids (sentinel N), or (P, 7)
    with each PE's bit0-2 inputs after its data0-3 (a fabric with a 1-bit
    layer); pe_res_idx: (N,) index into the flattened (res0, res1) PE
    results, (res0, res1, res_p) with the bit inputs, 2P (3P) for
    non-PE-output nodes. ``sel`` must lie in [0, F) and ``op`` in [0, 14),
    or [0, 19) with the bit inputs. Returns the (B, N) values after the
    fixpoint.

    On the card the variant follows :func:`fused_plan`: where a lane fits
    the shared memory of a cluster of 1-16 blocks, one cluster per lane
    keeps it there; past that, the global-memory variant. Each call runs
    in an ``emu.fused`` span: ``cluster`` is the variant it launched
    (blocks a lane; 0 for the global-memory variant), ``room`` the PE
    records a block has room for (0 for the global-memory variant),
    ``nodes`` its N, and ``kernel`` False where the plain version ran
    instead (CPU tensors: no cluster holds a lane, ``cluster`` 0)."""
    if vals0.device.type == "cpu":
        with span("emu.fused", cluster=0, room=0, nodes=vals0.shape[1],
                  kernel=False):
            return fabric_fused_batch_plain(
                vals0, sel, pin_vals, depths, op, const, imm_mask, imm_val,
                src, keep, pin_mask, pe_in, pe_res_idx, max_depth, word)
    kernel = "fabric_fused_batch"
    b, n = vals0.shape
    p = pe_in.shape[0]
    _check_fabric(kernel, b, n, p, depths, sel, op, const, imm_mask, imm_val,
                  src, keep, pin_mask, pe_in, pe_res_idx, vals0=vals0,
                  pin_vals=pin_vals)
    build.require_shape(kernel, "pin_vals", pin_vals, (b, n))
    out = torch.empty((b, n), dtype=torch.int32, device=vals0.device)
    if b == 0 or n == 0:
        return out
    pred = pe_outputs(pe_in) == 3
    cluster, room = fused_plan(kernel, src, pe_res_idx, pe_in)
    scratch = _fused_scratch(kernel, src, b, pred, cluster, room)
    with span("emu.fused", cluster=cluster, room=room, nodes=n,
              kernel=True):
        err = build.library().canal_fabric_fused_batch(
            depths.data_ptr(), vals0.data_ptr(), sel.data_ptr(),
            pin_vals.data_ptr(), op.data_ptr(), const.data_ptr(),
            imm_mask.data_ptr(), imm_val.data_ptr(), src.data_ptr(),
            keep.data_ptr(), pin_mask.data_ptr(), pe_in.data_ptr(),
            pe_res_idx.data_ptr(), _ptr(scratch, "node_of"),
            _ptr(scratch, "slot_of"), out.data_ptr(), _ptr(scratch, "buf"),
            _ptr(scratch, "picked"), b, n, src.shape[1], p, int(pred),
            int(max_depth), int(word), cluster, room,
            build.stream_ptr(vals0.device))
    build.check(err, kernel)
    build.count_launch(kernel)
    return out


def fabric_fused_run(sel: torch.Tensor, ext: torch.Tensor,
                     depths: torch.Tensor, op: torch.Tensor,
                     const: torch.Tensor, imm_mask: torch.Tensor,
                     imm_val: torch.Tensor, src: torch.Tensor,
                     keep: torch.Tensor, pin_mask: torch.Tensor,
                     pin_src: torch.Tensor, pe_in: torch.Tensor,
                     pe_res_idx: torch.Tensor, reg_src: torch.Tensor,
                     mem_in: torch.Tensor, io_out: torch.Tensor,
                     n_reg: int, n_io: int, n_mem: int, max_depth: int,
                     chunk: int = 8, word: int = 0xFFFF) -> torch.Tensor:
    """Streamed fused emulation: T cycles in one launch.

    sel: (B, N); ext: (B, T, n_io) stimulus; depths/op/const/imm_*/src/
    keep/pin_mask/pe_in/pe_res_idx as in :func:`fabric_fused_batch`;
    pin_src: (N,) node -> state slot ([regs | io | mem | zero] layout);
    reg_src: (R,) node feeding each register (sentinel N allowed);
    mem_in: (M,); io_out: (n_io,) observed port nodes. Returns (B, T,
    n_io) observations, bit-identical to scanning
    :func:`fabric_fused_batch` cycle by cycle. ``chunk`` (>= 1) is the
    stimulus block of the streamed contract; the kernel reads each
    cycle's stimulus straight from device memory, so it does not change
    the launch. The variant follows :func:`fused_plan`, as in
    :func:`fabric_fused_batch`; the cluster variant runs the whole cycle
    loop inside each lane's cluster."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if sel.device.type == "cpu":
        with span("emu.fused", cluster=0, room=0, nodes=sel.shape[1],
                  kernel=False):
            return fabric_fused_run_plain(
                sel, ext, depths, op, const, imm_mask, imm_val, src, keep,
                pin_mask, pin_src, pe_in, pe_res_idx, reg_src, mem_in,
                io_out, n_reg, n_io, n_mem, max_depth, chunk, word)
    b, n = sel.shape
    p = pe_in.shape[0]
    t_len = ext.shape[1]
    kernel = "fabric_fused_run"
    _check_fabric(kernel, b, n, p, depths, sel, op, const, imm_mask,
                  imm_val, src, keep, pin_mask, pe_in, pe_res_idx, ext=ext,
                  pin_src=pin_src, reg_src=reg_src, mem_in=mem_in,
                  io_out=io_out)
    for name, t, shape in [("ext", ext, (b, t_len, n_io)),
                           ("pin_src", pin_src, (n,)),
                           ("reg_src", reg_src, (n_reg,)),
                           ("mem_in", mem_in, (n_mem,)),
                           ("io_out", io_out, (n_io,))]:
        build.require_shape(kernel, name, t, shape)
    dev = sel.device
    obs = torch.empty((b, t_len, n_io), dtype=torch.int32, device=dev)
    if b == 0 or n == 0 or t_len == 0:
        return obs
    pred = pe_outputs(pe_in) == 3
    cluster, room = fused_plan(kernel, src, pe_res_idx, pe_in)
    scratch = _fused_scratch(kernel, src, b, pred, cluster, room,
                             state_words=n_reg + n_io + n_mem + 1)
    with span("emu.fused", cluster=cluster, room=room, nodes=n,
              kernel=True):
        err = build.library().canal_fabric_fused_run(
            depths.data_ptr(), sel.data_ptr(), op.data_ptr(), const.data_ptr(),
            imm_mask.data_ptr(), imm_val.data_ptr(), ext.data_ptr(),
            src.data_ptr(), keep.data_ptr(), pin_mask.data_ptr(),
            pin_src.data_ptr(), pe_in.data_ptr(), pe_res_idx.data_ptr(),
            reg_src.data_ptr(), mem_in.data_ptr(), io_out.data_ptr(),
            _ptr(scratch, "node_of"), _ptr(scratch, "slot_of"),
            obs.data_ptr(), _ptr(scratch, "buf"), _ptr(scratch, "picked"),
            _ptr(scratch, "pinv"), _ptr(scratch, "state"),
            b, n, src.shape[1], p, int(pred), t_len, n_reg, n_io, n_mem,
            int(max_depth), int(word), cluster, room, build.stream_ptr(dev))
    build.check(err, kernel)
    build.count_launch(kernel)
    return obs

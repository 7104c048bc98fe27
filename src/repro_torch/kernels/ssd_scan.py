"""Mamba-2 SSD chunked scan (counterpart of repro/kernels/ssd_scan.py).

The SSD recurrence per head (scalar decay ``a < 0``, state (P, N)):

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t (x) B_t
    y_t = C_t . h_t

computed chunk by chunk, all in float32, as the reference kernel does:
the sequence is zero-padded to a multiple of ``chunk`` (a padded dt of 0
leaves the state unchanged); in each chunk ``seg = cumsum(dt * a)``, the
carried state contributes ``(c h0^T) exp(seg)``, the chunk itself
``(tril(exp(seg_t - seg_u)) * (c b^T) * dt_u) x``, and the state moves
on to ``exp(seg_last) h0 + (x * dt exp(seg_last - seg))^T b``.

CUDA tensors run the hand-written kernel in ``csrc/ssd_scan.cu``, three
launches counted as one scan: every chunk's own state contribution in
parallel, the carry of the state over the chunks, then every chunk's
outputs in parallel; CPU tensors the plain PyTorch version beside it.
A shape split into blocks (below) counts one scan a block.

The kernel is instantiated for a few (chunk, P, N) (``KERNEL_SHAPES``)
and takes any shape through :func:`plan`: P and N are padded with zero
columns up to an instantiation's (a zero column of ``x`` gives a zero
column of ``y``; one of ``b`` or ``c`` adds nothing to ``c b^T`` or to
``c h^T``), and past the largest one split into blocks: the P columns
of ``y`` are independent, and every state dim n runs its own recurrence,
so ``y`` is the sum of the blocks' scans over N. The chunk is the
instantiation's, which changes only the float32 rounding order: the
chunked SSD is exact algebra for any chunk (L is zero-padded to it, as
the reference pads to its own).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build

#: (chunk, P, N) the CUDA kernel is instantiated for, smallest first: the
#: smoke configs' and Mamba2's
KERNEL_SHAPES = ((32, 16, 16), (128, 64, 128))


class SsdPlan(NamedTuple):
    """How the kernel runs a (chunk, P, N) scan: the instantiation
    ``shape`` (chunk, P, N) and the blocks ``p_blocks`` x ``n_blocks``
    of it that cover P and N (the last of each zero-padded)."""
    shape: Tuple[int, int, int]
    p_blocks: int
    n_blocks: int


def plan(chunk: int, p: int, n: int) -> SsdPlan:
    """The smallest instantiation that holds P and N, preferring one of
    the asked chunk; past the largest, the largest in blocks."""
    fits = [s for s in KERNEL_SHAPES if s[1] >= p and s[2] >= n]
    shape = ([s for s in fits if s[0] == chunk] or fits
             or [KERNEL_SHAPES[-1]])[0]
    return SsdPlan(shape, -(-p // shape[1]), -(-n // shape[2]))


def _cols(t: torch.Tensor, c0: int, width: int) -> torch.Tensor:
    """Columns c0 .. c0 + width of t's last dim, zero-padded past its
    end, contiguous and starting on 16 bytes (copied where ``t`` is not)."""
    part = t[..., c0:c0 + width]
    if part.shape[-1] == width:
        part = part.contiguous()
        return part if part.data_ptr() % 16 == 0 else part.clone()
    out = t.new_zeros(t.shape[:-1] + (width,))
    out[..., :part.shape[-1]] = part
    return out


def _pad(t: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return t
    shape = list(t.shape)
    shape[1] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=1)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor,
                   chunk: int = 128) -> torch.Tensor:
    """Plain PyTorch version of :func:`ssd_scan`: the reference kernel's
    per-chunk arithmetic, batched over BH, chunks in order."""
    bh, l, p = x.shape
    n = b.shape[-1]
    pad = (-l) % chunk
    xf, dtf = _pad(x.float(), pad), _pad(dt.float(), pad)
    bf, cf = _pad(b.float(), pad), _pad(c.float(), pad)
    af = a.float()
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=x.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ys = []
    for c0 in range(0, l + pad, chunk):
        xs = xf[:, c0:c0 + chunk]                       # (BH, C, P)
        dts = dtf[:, c0:c0 + chunk]                     # (BH, C)
        bs = bf[:, c0:c0 + chunk]                       # (BH, C, N)
        cs = cf[:, c0:c0 + chunk]
        seg = torch.cumsum(dts * af[:, None], dim=-1)   # (BH, C)
        y_inter = (cs @ h.transpose(1, 2)) * torch.exp(seg)[..., None]
        scores = cs @ bs.transpose(1, 2)                # (BH, C, C) t,u
        l_mat = torch.where(tri, torch.exp(seg[:, :, None]
                                           - seg[:, None, :]),
                            torch.zeros((), device=x.device))
        w = scores * l_mat * dts[:, None, :]
        ys.append(y_inter + w @ xs)
        seg_last = seg[:, -1:]
        decay_tail = torch.exp(seg_last - seg)           # (BH, C)
        xb = (xs * (dts * decay_tail)[..., None]).transpose(1, 2) @ bs
        h = torch.exp(seg_last)[..., None] * h + xb
    return torch.cat(ys, dim=1)[:, :l].to(x.dtype)


def _launch(x, dt, a, b, c, chunk: int) -> torch.Tensor:
    name = "ssd_scan"
    build.require(name, x.device, torch.float32, x=x, dt=dt, a=a, b=b, c=c)
    bh, l, p = x.shape
    n = b.shape[-1]
    build.require_shape(name, "dt", dt, (bh, l))
    build.require_shape(name, "a", a, (bh,))
    build.require_shape(name, "b", b, (bh, l, n))
    build.require_shape(name, "c", c, (bh, l, n))
    if x.numel() == 0:
        return torch.empty_like(x)
    how = plan(chunk, p, n)
    kc, kp, kn = how.shape
    chunks = -(-l // kc)
    # pass 1 writes each chunk's own state here, pass 2 turns it into the
    # chunk's start state in place, pass 3 reads it
    states = torch.empty((bh, chunks, kn, kp), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((bh, chunks), dtype=torch.float32, device=x.device)
    lib = build.library()
    ys = []
    for i in range(how.p_blocks):
        xi = _cols(x, i * kp, kp)
        yi = None
        for j in range(how.n_blocks):
            bj, cj = _cols(b, j * kn, kn), _cols(c, j * kn, kn)
            y = torch.empty_like(xi)
            build.check(lib.canal_ssd_scan(
                xi.data_ptr(), dt.data_ptr(), a.data_ptr(), bj.data_ptr(),
                cj.data_ptr(), y.data_ptr(), states.data_ptr(),
                decay.data_ptr(), bh, l, kp, kn, kc,
                build.stream_ptr(x.device)), name)
            build.count_launch(name)
            yi = y if yi is None else yi.add_(y)
        ys.append(yi)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)
    return y if y.shape[-1] == p else y[..., :p].contiguous()


@torch.library.custom_op("canal::ssd_scan", mutates_args=())
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk)
    return _launch(x, dt, a, b, c, chunk)


@_ssd_op.register_fake
def _(x, dt, a, b, c, chunk):
    return x.new_empty(x.shape)


def scan_flops(seq: int, p: int, n: int, chunk: int) -> int:
    """FLOPs of one head's scan: c.b^T and w.x over each chunk's causal
    (t, u) pairs; c.h0^T for every chunk after the first (h0 = 0 before
    it) and the state update for every chunk before the last (nothing
    reads the final state), 2 FLOPs a multiply-add."""
    lens = [min(chunk, seq - s0) for s0 in range(0, seq, chunk)]
    return (sum(cl * (cl + 1) * (n + p) for cl in lens)
            + 2 * n * p * (sum(lens[1:]) + sum(lens[:-1])))


@register_flop_formula(torch.ops.canal.ssd_scan)
def _(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk, *args,
      **kwargs) -> int:
    bh, seq, p = x_shape
    return bh * scan_flops(seq, p, b_shape[-1], chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             chunk: int = 128) -> torch.Tensor:
    """SSD forward. x: (BH, L, P); dt: (BH, L) > 0; a: (BH,) < 0; b, c:
    (BH, L, N), already head-grouped. Returns y (BH, L, P).

    It runs as the custom op ``torch.ops.canal.ssd_scan`` (a fake tensor
    takes its fake, a cost count its FLOP formula): CUDA tensors launch
    the kernel, CPU tensors take the plain version."""
    return torch.ops.canal.ssd_scan(x, dt, a, b, c, chunk)

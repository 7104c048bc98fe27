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
launches counted as one: every chunk's own state contribution in
parallel, the carry of the state over the chunks, then every chunk's
outputs in parallel (see the source for the shapes it takes); CPU
tensors the plain PyTorch version beside it.
"""
from __future__ import annotations

import torch

from . import build

#: (chunk, P, N) the CUDA kernel is instantiated for: Mamba2's
KERNEL_SHAPES = ((128, 64, 128),)


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
    if (chunk, p, n) not in KERNEL_SHAPES:
        raise ValueError(f"{name}: (chunk, P, N) = {(chunk, p, n)} not in "
                         f"{KERNEL_SHAPES}")
    build.require_shape(name, "dt", dt, (bh, l))
    build.require_shape(name, "a", a, (bh,))
    build.require_shape(name, "b", b, (bh, l, n))
    build.require_shape(name, "c", c, (bh, l, n))
    for arg, t in (("x", x), ("b", b), ("c", c)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} does not start on 16 bytes")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    chunks = -(-l // chunk)
    # pass 1 writes each chunk's own state here, pass 2 turns it into the
    # chunk's start state in place, pass 3 reads it
    states = torch.empty((bh, chunks, n, p), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((bh, chunks), dtype=torch.float32, device=x.device)
    err = build.library().canal_ssd_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), states.data_ptr(), decay.data_ptr(),
        bh, l, p, n, chunk, build.stream_ptr(x.device))
    build.check(err, name)
    build.count_launch(name)
    return y


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             chunk: int = 128) -> torch.Tensor:
    """SSD forward. x: (BH, L, P); dt: (BH, L) > 0; a: (BH,) < 0; b, c:
    (BH, L, N), already head-grouped. Returns y (BH, L, P)."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk)
    return _launch(x, dt, a, b, c, chunk)

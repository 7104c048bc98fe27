"""Flash attention, forward (counterpart of
repro/kernels/flash_attention.py).

Causal (or full) softmax attention with the reference kernel's numbers:
q is cast to float32 and multiplied by ``1/sqrt(D)`` before the dot;
scores, the running max and the denominator are float32; masked scores
are ``NEG_INF = -1e30`` (keys past the query position when causal, with
0-based positions for queries and keys alike); the output divides by
``max(l, 1e-30)`` and is cast back to q's dtype.

CUDA tensors run a hand-written kernel in ``csrc/flash_attention.cu``,
chosen by dtype: bfloat16 and float16 the tensor-core kernel (16-bit
``wgmma``, K/V tiles through a TMA ring, P carried as two terms of the
input type so the output stays within one ulp of the plain version),
float32 the CUDA-core kernel (full float32). Both run the online
softmax, skip causal tiles above the diagonal and index the GQA kv head
``h // rep`` instead of repeating it. CPU tensors run the plain PyTorch
version beside it.

Every head dim from 1 runs (:func:`plan`): up to 256 at a tile width
that holds it (64, 128 or 256 on the tensor cores, a multiple of 32 on
the CUDA cores), the columns past D read as zeros, which change neither
``Q K^T`` nor ``P V``, and the scale of the true D. Where a 16-bit row
of D elements is not a multiple of 16 bytes (D not a multiple of 8), or
a tensor does not start on 16 bytes, TMA cannot map it: the wrapper
copies q, k and v into buffers padded with zero columns to the next
multiple of 8, and returns the first D columns of the output. A head
dim past 256 runs, in any of the three dtypes, a CUDA-core kernel that
accumulates the scores over the whole D in 256-column panels and writes
one 256-column panel of the output a block (float32 throughout, P
unrounded). Nothing falls back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build

NEG_INF = -1.0e30
#: the largest head dim of the tile kernels; past it the panel kernel
MAX_TILE_DIM = 256
#: the tensor-core kernel's tile widths (its instantiations)
TC_WIDTHS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class FlashPlan(NamedTuple):
    """How the kernel runs head dim ``d``: ``kernel`` "tensor_core" or
    "cuda_core", its tile ``width`` (columns past ``d`` read as zeros;
    past 256, the width of a panel), and ``mem_dim``, the row width of
    the tensors it is handed (``d``, or ``d`` padded with zero columns to
    a multiple of 8)."""
    kernel: str
    width: int
    mem_dim: int


def plan(d: int, dtype: torch.dtype) -> FlashPlan:
    """The kernel, tile width and padding for head dim ``d`` in
    ``dtype``; raises on what no kernel takes."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: {dtype}, expected float32, "
                        f"bfloat16 or float16")
    if d < 1:
        raise ValueError(f"flash_attention: head dim {d} under 1")
    if d > MAX_TILE_DIM:
        return FlashPlan("cuda_core", MAX_TILE_DIM, d)
    if dtype == torch.float32:
        return FlashPlan("cuda_core", -(-d // 32) * 32, d)
    mem = -(-d // 8) * 8
    return FlashPlan("tensor_core", next(w for w in TC_WIDTHS if mem <= w),
                     mem)


def _padded(t: torch.Tensor, mem: int) -> torch.Tensor:
    """``t`` in a fresh buffer (aligned by the allocator), its last dim
    padded with zeros to ``mem``."""
    out = t.new_zeros(t.shape[:-1] + (mem,))
    out[..., :t.shape[-1]] = t
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The reference kernel's function on batch*heads pre-flattened:
    q (BH, Sq, D), k/v (BH, Skv, D) -> (BH, Sq, D) in q's dtype."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    if skv == 0:
        return torch.zeros_like(q)
    scale = 1.0 / (d ** 0.5)
    s = (q.float() * scale) @ k.float().transpose(1, 2)     # (BH, Sq, Skv)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    out = (p @ v.float()) / l_sum.clamp_min(1e-30)
    return out.to(q.dtype)


def flash_attention_gqa_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              causal: bool = True) -> torch.Tensor:
    """Plain GQA attention. q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D);
    kv head ``h // (Hq // Hkv)`` serves q head ``h`` (``jnp.repeat`` on
    the head axis, which is ``repeat_interleave``)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hkv != hq:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    out = flash_attention_plain(q.reshape(b * hq, sq, d),
                                k.reshape(b * hq, skv, d),
                                v.reshape(b * hq, skv, d), causal)
    return out.reshape(b, hq, sq, d)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """The CUDA kernel on (B, Hq, Sq, D) q and (B, Hkv, Skv, D) k/v."""
    name = "flash_attention"
    b, hq, sq, d = q.shape
    how = plan(d, q.dtype)
    build.require(name, q.device, q.dtype, q=q, k=k, v=v)
    hkv, skv = k.shape[1], k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{name}: {hq} q heads not a multiple of {hkv} "
                         f"kv heads")
    build.require_shape(name, "k", k, (b, hkv, skv, d))
    build.require_shape(name, "v", v, (b, hkv, skv, d))
    if q.numel() == 0:
        return torch.empty_like(q)
    mem = how.mem_dim
    if how.kernel == "tensor_core" and (
            mem != d or any(t.data_ptr() % 16 for t in (q, k, v))):
        q, k, v = (_padded(t, mem) for t in (q, k, v))
    out = q.new_empty((b, hq, sq, mem))
    err = build.library().canal_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, skv, mem, d, int(causal), _DTYPE_CODE[q.dtype],
        build.stream_ptr(q.device))
    build.check(err, name)
    build.count_launch(name)
    return out if mem == d else out[..., :d].contiguous()


@torch.library.custom_op("canal::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_gqa_plain(q, k, v, causal)
    return _launch(q, k, v, causal)


@_flash_op.register_fake
def _(q, k, v, causal):
    return q.new_empty(q.shape)


def causal_pairs(sq: int, skv: int, causal: bool = True) -> int:
    """The (q, k) pairs attention computes: query i sees keys 0..i (0-based
    positions for both, as the kernel counts them) when causal."""
    if not causal:
        return sq * skv
    full = min(sq, skv)
    return full * (full + 1) // 2 + max(sq - skv, 0) * skv


@register_flop_formula(torch.ops.canal.flash_attention)
def _(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    """4 D FLOPs a computed (q, k) pair: Q K^T and P V, 2 each."""
    b, hq, sq, d = q_shape
    return 4 * b * hq * d * causal_pairs(sq, k_shape[2], causal)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """GQA attention. q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D). The
    kernel indexes kv head ``h // rep``; the plain version repeats.

    It runs as the custom op ``torch.ops.canal.flash_attention`` (the
    kernel launches through ``data_ptr``, so a fake tensor needs the op's
    fake, and a cost count its FLOP formula): CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    return torch.ops.canal.flash_attention(q, k, v, causal)

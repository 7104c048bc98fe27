"""Flash attention, forward (counterpart of
repro/kernels/flash_attention.py).

Causal (or full) softmax attention with the reference kernel's numbers:
q is cast to float32 and multiplied by ``1/sqrt(D)`` before the dot;
scores, the running max and the denominator are float32; masked scores
are ``NEG_INF = -1e30`` (keys past the query position when causal, with
0-based positions for queries and keys alike); the output divides by
``max(l, 1e-30)`` and is cast back to q's dtype.

CUDA tensors run a hand-written kernel in ``csrc/flash_attention.cu``,
chosen by dtype: bfloat16 the tensor-core kernel (bf16 ``wgmma``, K/V
tiles through a TMA ring, P carried as two bf16 terms so the output stays
within one bf16 ulp of the plain version), float32 the CUDA-core kernel
(full float32). Both run the online softmax, skip causal tiles above the
diagonal and index the GQA kv head ``h // rep`` instead of repeating it.
CPU tensors run the plain PyTorch version beside it. The kernels take
head dim 64, 96, 112 or 128 (96 and 112, Phi-3's and Kimi K2's, at the
tile width of 128 with the columns past D read as zeros) and raise on
anything else before any launch; nothing falls back.
"""
from __future__ import annotations

import torch

from . import build

NEG_INF = -1.0e30
HEAD_DIMS = (64, 96, 112, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: q is {q.dtype}, expected float32 or "
                        f"bfloat16")
    build.require(name, q.device, q.dtype, q=q, k=k, v=v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{name}: {hq} q heads not a multiple of {hkv} "
                         f"kv heads")
    build.require_shape(name, "k", k, (b, hkv, skv, d))
    build.require_shape(name, "v", v, (b, hkv, skv, d))
    if b * hq > 65535:
        raise ValueError(f"{name}: batch*heads {b * hq} > 65535")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = build.library().canal_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, skv, d, int(causal), _DTYPE_CODE[q.dtype],
        build.stream_ptr(q.device))
    build.check(err, name)
    build.count_launch(name)
    return out


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """GQA attention. q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D). The
    kernel indexes kv head ``h // rep``; the plain version repeats."""
    if q.device.type == "cpu":
        return flash_attention_gqa_plain(q, k, v, causal)
    return _launch(q, k, v, causal)

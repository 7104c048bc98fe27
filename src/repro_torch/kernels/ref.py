"""Naive oracles (counterpart of repro/kernels/ref.py).

The plain versions that sit beside each kernel (``*_plain`` in
``fabric_step``, ``minplus``, ``hpwl``, ``flash_attention`` and
``ssd_scan``) mirror the kernels' own formulation. The oracles here do
not: ``fabric_fused_batch_ref`` places PE results by scatter through
``pe_out`` instead of the kernels' ``pe_res_idx`` gather, as the
reference's ``use_pallas=False`` fused path does; ``attention_ref`` is
one unblocked softmax and ``ssd_ref`` the step-by-step recurrence. The
two LM oracles compute in float32, or in float64 when given float64.
"""
from __future__ import annotations

import torch

from .fabric_step import PE_INPUTS, _picked, pe_alu_candidates, \
    pe_outputs


def fabric_fused_batch_ref(vals0, sel, pin_vals, depths, op, const,
                           imm_mask, imm_val, src, keep, pin_mask, pe_in,
                           pe_out, max_depth: int,
                           word: int = 0xFFFF) -> torch.Tensor:
    """Lane-batched gather -> hold-undriven -> re-pin -> PE-eval sweeps,
    each lane frozen once its own ``depths`` count is reached. PE outputs
    are named by ``pe_out`` (n_pe, n_cols) node ids; where ``pe_in`` has
    the 1-bit inputs (bit0-2 after data0-3) the third column, res_p,
    takes the result's low bit."""
    b, n = vals0.shape
    n_pe = pe_out.shape[0]
    zero = torch.zeros((b, 1), dtype=torch.int32, device=vals0.device)
    picked = _picked(src, sel)
    keep_b = (keep > 0)[None, :]
    pin_b = (pin_mask > 0)[None, :]
    pe_in = pe_in.long()
    pe_out = pe_out.long()
    depths = depths.to(vals0.device)
    v = vals0
    for t in range(max_depth):
        nv = torch.gather(torch.cat([v, zero], dim=1), 1, picked)
        nv = torch.where(keep_b, v, nv)
        nv = torch.where(pin_b, pin_vals, nv)
        ins = torch.cat([nv, zero], dim=1)[:, pe_in]      # (B, P, K)
        bits = ((ins[..., 4], ins[..., 5])
                if pe_outputs(pe_in) == 3 else None)
        ins = torch.where(imm_mask > 0, imm_val, ins[..., :PE_INPUTS])
        a, b_, c = ins[..., 0], ins[..., 1], ins[..., 2]
        cand = pe_alu_candidates(a, b_, c, const, bits)
        res = torch.gather(cand, 0, op.long()[None])[0]
        res0 = res & word
        res1 = a & word
        if n_pe:
            nv = nv.clone()
            nv[:, pe_out[:, 0]] = res0[:, :n_pe]
            if pe_out.shape[1] > 1:
                nv[:, pe_out[:, 1]] = res1[:, :n_pe]
            if pe_out.shape[1] > 2:
                nv[:, pe_out[:, 2]] = (res & 1)[:, :n_pe]
        v = torch.where((t < depths)[:, None], nv, v)
    return v


def _oracle_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Naive softmax attention. q: (BH, Sq, D), k/v: (BH, Skv, D)."""
    dt = _oracle_dtype(q)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.to(dt), k.to(dt)) * scale
    if causal:
        sq, skv = s.shape[-2], s.shape[-1]
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(dt)).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Naive SSD recurrence (the semantics the chunked kernel must match).

    h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T ;  y_t = h_t C_t
    x: (BH, L, P), dt: (BH, L), a: (BH,), b/c: (BH, L, N) -> y (BH, L, P)
    """
    out_dtype, f = x.dtype, _oracle_dtype(x)
    x, dt, a, b, c = (t.to(f) for t in (x, dt, a, b, c))
    bh, l, p = x.shape
    h = torch.zeros((bh, p, b.shape[-1]), dtype=f, device=x.device)
    ys = []
    for t in range(l):
        h = (torch.exp(dt[:, t] * a)[:, None, None] * h
             + dt[:, t, None, None] * x[:, t, :, None] * b[:, t, None, :])
        ys.append(h @ c[:, t, :, None])                  # (BH, P, 1)
    return torch.cat(ys, dim=-1).transpose(1, 2).to(out_dtype)

"""Scatter-based oracle of the fused engine (counterpart of
repro/kernels/ref.py:fabric_fused_batch_ref).

The plain versions that sit beside each kernel (``*_plain`` in
``fabric_step``, ``minplus`` and ``hpwl``) mirror the kernels' own
formulation; this oracle places PE results by scatter through ``pe_out``
instead of the kernels' ``pe_res_idx`` gather, as the reference's
``use_pallas=False`` fused path does.
"""
from __future__ import annotations

import torch

from .fabric_step import _picked, pe_alu_candidates


def fabric_fused_batch_ref(vals0, sel, pin_vals, depths, op, const,
                           imm_mask, imm_val, src, keep, pin_mask, pe_in,
                           pe_out, max_depth: int,
                           word: int = 0xFFFF) -> torch.Tensor:
    """Lane-batched gather -> hold-undriven -> re-pin -> PE-eval sweeps,
    each lane frozen once its own ``depths`` count is reached. PE outputs
    are named by ``pe_out`` (n_pe, n_cols) node ids."""
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
        ins = torch.cat([nv, zero], dim=1)[:, pe_in]      # (B, P, 4)
        ins = torch.where(imm_mask > 0, imm_val, ins)
        a, b_, c = ins[..., 0], ins[..., 1], ins[..., 2]
        cand = pe_alu_candidates(a, b_, c, const)
        res0 = torch.gather(cand, 0, op.long()[None])[0] & word
        res1 = a & word
        if n_pe:
            nv = nv.clone()
            nv[:, pe_out[:, 0]] = res0[:, :n_pe]
            if pe_out.shape[1] > 1:
                nv[:, pe_out[:, 1]] = res1[:, :n_pe]
        v = torch.where((t < depths)[:, None], nv, v)
    return v

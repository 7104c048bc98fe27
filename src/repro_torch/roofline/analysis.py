"""Three-term roofline (counterpart of repro/roofline/analysis.py).

The reference feeds it the compiled dry-run artifact (§Roofline); the
port's dry run (:mod:`repro_torch.launch.dryrun`) feeds it the per-device
counts of :mod:`repro_torch.roofline.cost`, with ``chip=H100_SXM``.

    compute term    = HLO_FLOPs / (chips x peak_FLOP/s)
    memory term     = HLO_bytes / (chips x HBM_bw)
    collective term = link_bytes_per_chip / (links x link_bw)

``cost_analysis()`` on a partitioned executable reports *per-device*
numbers, so chips divide out of the first two terms; the collective term
comes from the HLO parse (already per chip). MODEL_FLOPS = 6·N·D (dense)
or 6·N_active·D (MoE) measures how much of the compiled compute is
"useful" (catches remat/dispatch waste).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from .hw import ChipSpec, TPU_V5E


def model_flops(n_params_active: float, tokens: float,
                kind: str = "train") -> float:
    """6·N·D for training (fwd 2ND + bwd 4ND); 2·N·D for inference."""
    if kind == "train":
        return 6.0 * n_params_active * tokens
    return 2.0 * n_params_active * tokens


def roofline_terms(per_device_flops: float, per_device_hbm_bytes: float,
                   per_chip_link_bytes: float,
                   chip: ChipSpec = TPU_V5E) -> Dict[str, float]:
    compute_s = per_device_flops / chip.peak_flops_bf16
    memory_s = per_device_hbm_bytes / chip.hbm_bw
    collective_s = per_chip_link_bytes / (chip.ici_links * chip.ici_link_bw)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    total = max(bound, 1e-30)
    terms["dominant"] = dom
    terms["bound_s"] = bound
    # fraction of roofline the *compute* achieves if perfectly overlapped
    terms["roofline_fraction"] = compute_s / total
    return terms


def count_params(params) -> float:
    """Parameters of an ``nn.Module`` (its ``parameters()``, each shared
    tensor once) or of a (nested) mapping of tensors or arrays. A DTensor
    or a fake tensor counts its global elements."""
    if hasattr(params, "parameters"):
        return float(sum(p.numel() for p in params.parameters()))
    total = 0
    for v in params.values():
        if isinstance(v, Mapping):
            total += count_params(v)
        else:
            total += int(np.prod(v.shape))
    return float(total)


def active_params(cfg, total_params: float) -> float:
    """MoE: only top-k of the expert params are active per token."""
    if cfg.moe is None or cfg.moe.num_experts == 0:
        return total_params
    m = cfg.moe
    # expert weights: 3 matrices per expert per MoE layer
    n_moe_layers = cfg.num_layers - m.first_k_dense
    expert_p = n_moe_layers * m.num_experts * 3 * cfg.d_model \
        * m.d_ff_expert
    active_expert_p = expert_p * m.top_k / m.num_experts
    return total_params - expert_p + active_expert_p

"""Hardware constants for the roofline analysis (counterpart of
repro/roofline/hw.py).

``TPU_V5E`` is the reference's, unchanged: it is the subject of the pod
model (:mod:`repro_torch.core.ici`). ``H100_SXM`` is the card the port
runs on. Its figures are NVIDIA data-sheet constants (the H100 Tensor
Core GPU data sheet, SXM column), not measurements.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    hbm_bw: float               # bytes/s per chip
    ici_link_bw: float          # bytes/s per link
    ici_links: int              # links per chip (2D torus: 4)
    hbm_bytes: float            # capacity per chip
    dci_bw: float               # inter-pod bytes/s per chip (approx)


TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_link_bw=50e9,
    ici_links=4,
    hbm_bytes=16 * 1024**3,
    dci_bw=6.25e9,
)

H100_SXM = ChipSpec(
    name="h100-sxm",
    # BF16 tensor core, dense (the data sheet's 1,979 TFLOP/s is with
    # 2:4 sparsity)
    peak_flops_bf16=989e12,
    # HBM3, 3.35 TB/s
    hbm_bw=3.35e12,
    # fourth-generation NVLink: 900 GB/s a GPU over 18 links
    ici_link_bw=900e9 / 18,
    ici_links=18,
    # 80 GB of HBM3
    hbm_bytes=80e9,
    # between nodes: one 400 Gb/s NDR InfiniBand port a GPU (ConnectX-7,
    # as in the DGX H100 data sheet)
    dci_bw=400e9 / 8,
)

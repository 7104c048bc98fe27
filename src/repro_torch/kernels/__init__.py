"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions.

- fabric_step: single sweeps (``fabric_sweep``, ``fabric_sweep_batch``),
  the fused fabric fixpoint (``fabric_fused_batch``) and the T-cycle
  streamed engine (``fabric_fused_run``)
- rv_sweep: a ready-valid cycle's sweeps in one launch (``rv_sweeps``)
- cluster_plan: the shared-memory plan both cluster kernels share
- minplus: tropical relaxation for batched routing wavefronts
- hpwl: per-net pin bounding boxes seeding the batched annealer, and
  per-net HPWL (Eq. 2's distance term)
- flash_attention: causal/full softmax attention with GQA (the LM
  substrate's full-sequence forward)
- ssd_scan: the Mamba-2 SSD chunked scan
- build: nvcc build of ``csrc/`` into ``build/kernels`` and launch counts
"""
from . import ops, ref  # noqa: F401

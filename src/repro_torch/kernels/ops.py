"""Public entry points of the port's kernels (counterpart of
repro/kernels/ops.py).

The reference resolves Pallas interpret mode here; in the port each
wrapper dispatches on the device of the tensors it is given (the CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors), so
this module only gathers them under one name.
"""
import torch

from . import flash_attention as _flash
from . import ssd_scan as _ssd
from .fabric_step import (fabric_fused_batch, fabric_fused_run,  # noqa: F401
                          fabric_sweep, fabric_sweep_batch)
from .hpwl import hpwl, net_bboxes  # noqa: F401
from .minplus import (minplus_fixpoint, minplus_step,  # noqa: F401
                      minplus_wavefront)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """GQA-aware wrapper. q: (B, Hq, S, D); k/v: (B, Hkv, S, D), in any
    layout (the kernel takes them contiguous)."""
    return _flash.flash_attention_gqa(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             chunk: int = 128) -> torch.Tensor:
    return _ssd.ssd_scan(x, dt, a, b, c, chunk=chunk)

"""Public entry points of the port's kernels (counterpart of
repro/kernels/ops.py).

The reference resolves Pallas interpret mode here; in the port each
wrapper dispatches on the device of the tensors it is given (the CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors), so
this module only gathers them under one name.
"""
from .fabric_step import (fabric_fused_batch, fabric_fused_run,  # noqa: F401
                          fabric_sweep, fabric_sweep_batch)
from .hpwl import hpwl, net_bboxes  # noqa: F401
from .minplus import (minplus_fixpoint, minplus_step,  # noqa: F401
                      minplus_wavefront)

"""PyTorch/CUDA port of the Canal reproduction (the JAX package ``repro``
is its reference).

The port mirrors ``repro`` path for path: ``repro_torch/core/lowering.py``
is the counterpart of ``repro/core/lowering.py``, and so on. It imports
``torch`` and numpy, never JAX and never the reference package. Its entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
the hand-written kernels under ``kernels/csrc`` launch for CUDA tensors,
and their plain PyTorch versions run only for tensors on the CPU.
"""

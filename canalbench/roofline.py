"""The yardstick of the kernels' roofline shares, frozen here.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
``CUDA_CORE_OPS_PER_S``, ``bound``): the least time for some work is the
larger of its bytes over the memory rate and its operations over the
CUDA-core rate. Unlike ``chip_smoke.py`` the work is counted from the
problem's shapes (the fabric's nodes and fan-in, each lane's routed
depth, the cycles, lanes and IOs), never from what the kernel that ran
happened to read, so a later kernel that reads less or sweeps less does
not move the yardstick. Each input byte is counted read once and each
output byte written once.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit).
"""
from __future__ import annotations

from typing import Dict, Sequence

#: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
#: float32 / integer operations per second outside the tensor cores
CUDA_CORE_OPS_PER_S = 67e12
#: bytes of one fabric word as the program stores it (int32)
WORD_BYTES = 4


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take for the work."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / CUDA_CORE_OPS_PER_S)


def emulation_batch(connections: int, num_config: int, num_pe: int,
                    num_io: int, depths: Sequence[int],
                    cycles: int) -> Dict[str, float]:
    """One batched emulation: every lane settles its routed
    combinational depth of sweeps each cycle, and a sweep looks at every
    (mux, input) connection once. Read: the fabric's connection table,
    each lane's selects, PE program (op, const, four immediates and
    their mask) and stimulus; written: each lane's IO observations."""
    lanes = len(depths)
    ops = float(sum(int(d) for d in depths)) * cycles * connections
    n_bytes = WORD_BYTES * (connections
                            + lanes * (num_config + 10 * num_pe)
                            + 2 * lanes * cycles * num_io)
    return {"bytes": float(n_bytes), "ops": ops}


def rv_cycles(connections: int, num_config: int, fifo_stages: int,
              num_io: int, depth: int, cycles: int) -> Dict[str, float]:
    """``cycles`` ready-valid cycles of one configuration: each cycle
    settles ``depth`` forward sweeps of data and valid and ``depth``
    backward sweeps of ready over every connection, and updates every
    FIFO stage. Read once: the connection table and the selects; each
    cycle the drive (data, valid, sink ready) and the FIFO state (two
    slots and the occupancy) are read and the state and observations
    (data, valid, accepted) written."""
    ops = float(cycles) * depth * connections * 3 + cycles * fifo_stages
    n_bytes = WORD_BYTES * (connections + num_config
                            + cycles * (6 * num_io + 6 * fifo_stages))
    return {"bytes": float(n_bytes), "ops": ops}

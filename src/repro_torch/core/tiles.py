"""Core definitions dropped into interconnect tiles.

Cores are port bundles at the IR level (Canal is agnostic to the core's
internals); each core also carries a *functional model* — a pure function on
int32 words — used by the JAX fabric backend, and PnR metadata (op names it
can implement, intrinsic delay).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence


from .graph import Core, PortSpec

WORD = 0xFFFF  # 16-bit datapath mask


#: a PE's 1-bit predicate ports (Garnet's names), on arrays with a 1-bit
#: routing layer: three inputs and one output
PE_BIT_INPUTS = ("bit0", "bit1", "bit2")
PE_BIT_OUTPUT = "res_p"
#: an IO tile's 1-bit ports: pad to fabric, fabric to pad
IO_BIT_OUT, IO_BIT_IN = "io2f_1", "f2io_1"


class PECore(Core):
    """Processing element: 4 data inputs, 2 outputs (paper §4.1 baseline).

    The functional model implements a small ALU chosen by the PE opcode
    (part of the core config, not the interconnect bitstream). With
    ``pred`` (an array with a 1-bit routing layer) the PE also has the
    1-bit inputs ``bit0``-``bit2`` and the 1-bit output ``res_p`` (the
    ALU result's low bit), and the ``PRED_OPS``: unsigned compares of
    data0 and data1 (a 0/1 result), ``psel`` (``bit0 ? data0 : data1``)
    and ``pand`` (``bit0 & bit1``).
    """

    core_type = "pe"
    delay = 0.8  # ns through the ALU, GF12-ish

    OPS = ("add", "sub", "mul", "and", "or", "xor", "shl", "shr", "min",
           "max", "abs", "sel", "const", "pass")
    PRED_OPS = ("ugt", "uge", "ult", "psel", "pand")

    def __init__(self, width: int = 16, num_inputs: int = 4,
                 num_outputs: int = 2, pred: bool = False):
        self.width = width
        self.num_inputs = num_inputs
        self.num_outputs = num_outputs
        self.pred = pred
        ports = [PortSpec(f"data{i}", width, True) for i in range(num_inputs)]
        ports += [PortSpec(f"res{i}", width, False)
                  for i in range(num_outputs)]
        if pred:
            ports += [PortSpec(p, 1, True) for p in PE_BIT_INPUTS]
            ports.append(PortSpec(PE_BIT_OUTPUT, 1, False))
        super().__init__(ports)

    @staticmethod
    def evaluate(op: str, operands: Sequence[int], const: int = 0) -> int:
        a = operands[0] if len(operands) > 0 else 0
        b = operands[1] if len(operands) > 1 else 0
        c = operands[2] if len(operands) > 2 else 0
        if op == "add":
            r = a + b
        elif op == "sub":
            r = a - b
        elif op == "mul":
            r = a * b
        elif op == "and":
            r = a & b
        elif op == "or":
            r = a | b
        elif op == "xor":
            r = a ^ b
        elif op == "shl":
            r = a << (b & 0xF)
        elif op == "shr":
            r = a >> (b & 0xF)
        elif op == "min":
            r = min(a, b)
        elif op == "max":
            r = max(a, b)
        elif op == "abs":
            r = abs(a - b)
        elif op == "sel":
            r = b if (a & 1) else c
        elif op == "const":
            r = const
        elif op == "pass":
            r = a
        else:
            raise ValueError(f"unknown PE op {op}")
        return int(r) & WORD


class MemCore(Core):
    """Memory core: behaves as a configurable delay line / ROM for the
    functional tests (the real MEM has many modes; line-buffer semantics are
    what image pipelines use)."""

    core_type = "mem"
    delay = 1.0

    def __init__(self, width: int = 16, depth: int = 512):
        self.width = width
        self.depth = depth
        ports = [
            PortSpec("wdata", width, True),
            PortSpec("waddr", width, True),
            PortSpec("raddr", width, True),
            PortSpec("flush", width, True),
            PortSpec("rdata", width, False),
            PortSpec("valid", width, False),
        ]
        super().__init__(ports)


class IOCore(Core):
    """Array-edge IO: one input stream in, one output stream out; with
    ``pred`` also a 1-bit pair (``io2f_1`` in, ``f2io_1`` out)."""

    core_type = "io"
    delay = 0.1

    def __init__(self, width: int = 16, pred: bool = False):
        self.width = width
        ports = [
            PortSpec("io_in", width, True),   # from array to pad
            PortSpec("io_out", width, False),  # from pad into array
        ]
        if pred:
            ports += [PortSpec(IO_BIT_IN, 1, True),
                      PortSpec(IO_BIT_OUT, 1, False)]
        super().__init__(ports)


CORE_FACTORIES: Dict[str, Callable[..., Core]] = {
    "pe": PECore,
    "mem": MemCore,
    "io": IOCore,
}


def default_core_assigner(mem_columns: Sequence[int] = (),
                          io_ring: bool = False,
                          pe_inputs: int = 4, pe_outputs: int = 2,
                          width: int = 16, pred: bool = False
                          ) -> Callable[[int, int, int, int],
                                        Optional[Core]]:
    """Returns core_fn(x, y, W, H) -> Core placing MEM cores on the given
    columns and PEs elsewhere; optionally an IO ring on the array border.
    ``pred`` gives PEs and IOs their 1-bit ports."""

    def core_fn(x: int, y: int, w: int, h: int) -> Optional[Core]:
        if io_ring and (x in (0, w - 1) or y in (0, h - 1)):
            return IOCore(width, pred)
        if x in mem_columns:
            return MemCore(width)
        return PECore(width, pe_inputs, pe_outputs, pred)

    return core_fn

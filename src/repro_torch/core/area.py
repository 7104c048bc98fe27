"""Analytical PPA model (§4, GF12 calibration).

We cannot run GlobalFoundries 12 nm synthesis in this container, so area is
an analytical standard-cell model computed *from the IR graph itself* — the
same graph the hardware is generated from — with constants calibrated so
the paper's reported ratios reproduce:

* Fig. 8 — ready-valid FIFO SBs: full depth-2 FIFOs ≈ +54 % SB area over
  the static baseline; split FIFOs ≈ +32 %.
* Fig. 10 — SB and CB area grow with track count (near-linear).
* Fig. 13 — SB/CB area shrink as core-port connections are depopulated.

All constants are µm²-scale GF12-ish numbers; *ratios* are the validated
quantity (see tests/test_area.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Optional

from .graph import Interconnect, InterconnectGraph, Node, NodeKind


@dataclass(frozen=True)
class AreaConstants:
    """GF12-calibrated standard-cell areas (µm²)."""

    mux2_per_bit: float = 0.6       # 2:1 mux slice
    config_bit: float = 1.2         # config store flop + scan
    ff_per_bit: float = 1.0         # pipeline register flop
    rv_join_per_input: float = 0.4  # Fig. 5 one-hot AOI join, per input
    rv_join_lut_per_input: float = 3.2   # naive LUT join (rejected design)
    fifo_ctrl_full: float = 15.35   # depth-2 FIFO ctrl (registered ready)
    fifo_ctrl_split: float = 16.2   # split-FIFO controller (chained handshake)
    valid_wire_bit: float = 0.0     # valid net is routed with data muxes


CONST = AreaConstants()


def mux_area(n_inputs: int, width: int, c: AreaConstants = CONST) -> float:
    """n:1 mux tree + its configuration bits."""
    if n_inputs <= 1:
        return 0.0
    sel_bits = max(1, math.ceil(math.log2(n_inputs)))
    return (n_inputs - 1) * c.mux2_per_bit * width + sel_bits * c.config_bit


def register_area(width: int, c: AreaConstants = CONST) -> float:
    return width * c.ff_per_bit


def rv_mux_overhead(n_inputs: int, c: AreaConstants = CONST,
                    use_lut: bool = False) -> float:
    """Ready-valid overhead of one mux: the 1-bit valid copy of the mux plus
    the ready-join. ``use_lut=True`` models the naive LUT join the paper
    rejects (Fig. 5 discussion)."""
    if n_inputs <= 1:
        return 0.0
    valid = (n_inputs - 1) * c.mux2_per_bit * 1
    join = n_inputs * (c.rv_join_lut_per_input if use_lut
                       else c.rv_join_per_input)
    return valid + join


def fifo_overhead(width: int, mode: str, c: AreaConstants = CONST) -> float:
    """Per-register FIFO overhead (Fig. 6 / Fig. 8).

    full:  one extra data slot (depth-2) + a registered-ready controller.
    split: storage reused from the neighbouring tile's register; only the
           (slightly larger, chained-handshake) controller is added.
    """
    if mode == "none":
        return 0.0
    if mode == "full":
        return width * c.ff_per_bit + c.fifo_ctrl_full
    if mode == "split":
        return c.fifo_ctrl_split
    raise ValueError(f"unknown fifo mode {mode}")


# ---------------------------------------------------------------------------
# Graph-driven area accounting
# ---------------------------------------------------------------------------


def _tile_nodes(g: InterconnectGraph, x: int, y: int) -> Iterable[Node]:
    tile = g.get_tile(x, y)
    if tile is None:
        return []
    nodes = list(tile.nodes())
    nodes += [r for r in g.registers if (r.x, r.y) == (x, y)]
    nodes += [m for m in g.reg_muxes if (m.x, m.y) == (x, y)]
    return nodes


def tile_area_breakdown(ic: Interconnect, x: int, y: int,
                        rv: Optional[str] = None,
                        c: AreaConstants = CONST,
                        use_lut_join: bool = False) -> Dict[str, float]:
    """Area of one tile's interconnect, split into SB / CB / FIFO parts.

    rv: None (static), "full", or "split" — the ready-valid FIFO mode.
    """
    sb = cb = fifo = 0.0
    if rv is None:
        rv_mode = "none"
    else:
        rv_mode = rv
    for g in ic.graphs.values():
        for node in _tile_nodes(g, x, y):
            n_in = len(node.fan_in)
            a = mux_area(n_in, node.width, c)
            rv_a = (rv_mux_overhead(n_in, c, use_lut_join)
                    if rv_mode != "none" else 0.0)
            if node.kind == NodeKind.PORT:
                if n_in:                      # CB mux in front of core input
                    cb += a + rv_a
            elif node.kind == NodeKind.REGISTER:
                sb += register_area(node.width, c)
                fifo += fifo_overhead(node.width, rv_mode, c)
            else:                             # SB + register muxes
                sb += a + rv_a
    return {"sb": sb, "cb": cb, "fifo": fifo, "total": sb + cb + fifo}


def switch_box_area(ic: Interconnect, rv: Optional[str] = None,
                    c: AreaConstants = CONST, x: Optional[int] = None,
                    y: Optional[int] = None) -> float:
    """SB area (incl. track registers + FIFO overhead) of an interior tile —
    the quantity plotted in Figs. 8/10/13."""
    if x is None or y is None:
        w, h = ic.dims()
        x, y = w // 2, h // 2
    b = tile_area_breakdown(ic, x, y, rv=rv, c=c)
    return b["sb"] + b["fifo"]


def connection_box_area(ic: Interconnect, c: AreaConstants = CONST,
                        x: Optional[int] = None, y: Optional[int] = None
                        ) -> float:
    if x is None or y is None:
        w, h = ic.dims()
        x, y = w // 2, h // 2
    return tile_area_breakdown(ic, x, y, c=c)["cb"]


def interconnect_area(ic: Interconnect, rv: Optional[str] = None,
                      c: AreaConstants = CONST) -> Dict[str, float]:
    """Whole-array interconnect area."""
    w, h = ic.dims()
    tot = {"sb": 0.0, "cb": 0.0, "fifo": 0.0, "total": 0.0}
    for x in range(w):
        for y in range(h):
            b = tile_area_breakdown(ic, x, y, rv=rv, c=c)
            for k in tot:
                tot[k] += b[k]
    return tot


# ---------------------------------------------------------------------------
# Energy model (coarse): per-access switching energy, used for DSE ranking
# ---------------------------------------------------------------------------

ENERGY_PJ = {
    "mux_per_bit": 0.0022,
    "wire_hop_per_bit": 0.011,
    "reg_per_bit": 0.0045,
}


def route_energy_pj(n_mux_crossings: int, n_hops: int, n_regs: int,
                    width: int = 16) -> float:
    e = (n_mux_crossings * ENERGY_PJ["mux_per_bit"]
         + n_hops * ENERGY_PJ["wire_hop_per_bit"]
         + n_regs * ENERGY_PJ["reg_per_bit"])
    return e * width

"""Packing stage (§3.4): fold constants and pipeline registers into PEs.

"Constants and registers in the application are analyzed to identify any
packing opportunities. For example, a pipeline register that feeds directly
into a PE can be packed within that PE, eliminating the need to place that
register on the configurable interconnect."
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .app import AppGraph, AppInstance, Net


#: the PE input ports with an immediate slot, and the slot of each: a
#: constant packs into a data input only
IMM_SLOTS = {"data0": 0, "data1": 1, "data2": 2, "data3": 3}


@dataclass
class PackedGraph:
    """Post-packing netlist: only placeable instances (pe/mem/io) remain;
    packed consts/regs are recorded as attributes on their host PE."""

    app: AppGraph
    placeable: Dict[str, AppInstance] = field(default_factory=dict)
    nets: List[Net] = field(default_factory=list)
    #: host PE -> {port -> const value}
    const_ports: Dict[str, Dict[str, int]] = field(default_factory=dict)
    #: host PE -> input ports that absorb one register delay
    reg_ports: Dict[str, List[str]] = field(default_factory=dict)


def pack(app: AppGraph) -> PackedGraph:
    app.validate()
    packed = PackedGraph(app=app)
    drop: Dict[str, Tuple[str, str]] = {}   # folded inst -> (host, port)

    # 1. constants feeding exactly one PE input -> PE immediate; a PE input
    # without an immediate slot (the 1-bit bit0-2) takes no constant
    for inst in app.instances.values():
        if inst.kind != "const":
            continue
        outs = app.fanout_of(inst.name)
        for net in outs:
            for sink, port in net.sinks:
                if (app.instances[sink].kind == "pe"
                        and port not in IMM_SLOTS):
                    raise ValueError(
                        f"constant {inst.name!r} feeds {sink}.{port}: PE "
                        f"port {port!r} has no immediate slot (only "
                        f"{', '.join(IMM_SLOTS)} do)")
        if len(outs) == 1 and len(outs[0].sinks) == 1:
            sink, port = outs[0].sinks[0]
            if app.instances[sink].kind == "pe":
                inst.packed_into = sink
                drop[inst.name] = (sink, port)
                packed.const_ports.setdefault(sink, {})[port] = inst.const

    # 2. registers feeding exactly one PE -> absorbed into PE input
    for inst in app.instances.values():
        if inst.kind != "reg":
            continue
        outs = app.fanout_of(inst.name)
        if len(outs) == 1 and len(outs[0].sinks) == 1:
            sink, port = outs[0].sinks[0]
            if app.instances[sink].kind == "pe":
                inst.packed_into = sink
                drop[inst.name] = (sink, port)
                packed.reg_ports.setdefault(sink, []).append(port)

    # 3. rebuild netlist: bypass dropped instances
    for name, inst in app.instances.items():
        if name in drop:
            continue
        if inst.kind in ("pe", "mem", "io_in", "io_out"):
            packed.placeable[name] = inst
        elif inst.kind == "reg":
            # unpacked register: becomes an interconnect register demand;
            # keep it placeable on a PE in pass mode (fallback)
            inst.kind = "pe"
            inst.op = "pass"
            packed.placeable[name] = inst

    for net in app.nets:
        src, sport = net.src
        if src in drop:
            # register absorbed: the net into the register is extended in
            # the loop below (we skip reg->pe nets; const nets vanish)
            continue
        sinks = []
        for s, p in net.sinks:
            if s in drop:
                host, hport = drop[s]
                if app.instances[s].kind == "const":
                    continue                     # const folded: net vanishes
                sinks.append((host, hport))      # reg folded: reconnect
            else:
                sinks.append((s, p))
        if not sinks:
            continue
        packed.nets.append(Net(net.name, (src, sport), sinks))

    # 4. merge nets sharing a driver port (fan-out is one net, §3.3)
    merged: Dict[Tuple[str, str], Net] = {}
    order: List[Tuple[str, str]] = []
    for net in packed.nets:
        key = net.src
        if key in merged:
            for s in net.sinks:
                if s not in merged[key].sinks:
                    merged[key].sinks.append(s)
        else:
            merged[key] = Net(net.name, net.src, list(net.sinks))
            order.append(key)
    packed.nets = [merged[k] for k in order]

    return packed

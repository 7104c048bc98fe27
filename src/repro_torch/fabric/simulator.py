"""Application emulation on a generated fabric.

Given a placed-and-routed application (see ``repro_torch.core.pnr``), drive the
static fabric cycle by cycle: external streams enter at IO tiles, PEs
compute, and the emulator collects outputs. Used by the integration tests
to check that *applications* (not just connections) behave correctly on
the generated interconnect. (Counterpart of repro/fabric/simulator.py;
configs and PE programs live on the fabric's device.)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Node
from repro_torch.core.lowering import FabricModule, PE_OP_IDS, PRED_OP_IDS
from repro_torch.core.pnr.packing import IMM_SLOTS
from repro_torch.core.pnr.route import fabric_port
from repro_torch.obs import span

Coord = Tuple[int, int]


class AppEmulator:
    """Binds a routed application to a fabric and runs it.

    Inputs and outputs are keyed by IO tile. ``io_ports`` names the IO
    ports the app uses at a tile where they are not the data pair
    (``io_out`` driven, ``io_in`` observed), e.g. ``{(0, 3): ("io2f_1",)}``
    for a 1-bit input: the tile's stimulus then drives that port, masked
    to its width, and its observation reads it."""

    def __init__(self, fabric: FabricModule,
                 route_edges: Sequence[Tuple[Node, Node]],
                 pe_ops: Dict[Coord, Tuple[str, int]],
                 pe_imms: Optional[Dict[Coord, Dict[int, int]]] = None,
                 depth: Optional[int] = None,
                 io_ports: Optional[Dict[Coord, Sequence[str]]] = None):
        self.fabric = fabric
        self.config = torch.as_tensor(fabric.route_to_config(route_edges),
                                      device=fabric.device)
        n = max(fabric.num_pe, 1)
        ops = np.full(n, PE_OP_IDS["pass"], np.int32)
        consts = np.zeros(n, np.int32)
        imm_mask = np.zeros((n, 4), np.int32)
        imm_val = np.zeros((n, 4), np.int32)
        coord_to_pe = {c: i for i, c in enumerate(fabric.pe_coords)}
        op_ids = dict(PE_OP_IDS, **(PRED_OP_IDS if fabric.pred else {}))
        for coord, (op, const) in pe_ops.items():
            if op not in op_ids:
                raise ValueError(
                    f"PE op {op!r} at {coord}: "
                    + ("it needs the PE's 1-bit ports, which a fabric "
                       "without a 1-bit layer lacks" if op in PRED_OP_IDS
                       else "not an op of the PE"))
            ops[coord_to_pe[coord]] = op_ids[op]
            consts[coord_to_pe[coord]] = const
        for coord, ports in (pe_imms or {}).items():
            for port_idx, val in ports.items():
                imm_mask[coord_to_pe[coord], port_idx] = 1
                imm_val[coord_to_pe[coord], port_idx] = val
        self.pe_cfg = {k: torch.as_tensor(v, device=fabric.device)
                       for k, v in (("op", ops), ("const", consts),
                                    ("imm_mask", imm_mask),
                                    ("imm_val", imm_val))}
        #: each IO tile's drive column and observed column: its data pair's
        #: (the first column of the tile), or those of ``io_ports``
        self.in_index: Dict[Coord, int] = {}
        self.io_index: Dict[Coord, int] = {}
        column: Dict[Tuple[Coord, str], int] = {}
        for i, (c, (drive, seen)) in enumerate(zip(fabric.io_coords,
                                                   fabric.io_ports)):
            self.in_index.setdefault(c, i)
            self.io_index.setdefault(c, i)
            column[c, drive] = column[c, seen] = i
        drives = {d for d, _ in fabric.io_ports}
        for c, ports in (io_ports or {}).items():
            for p in ports:
                if (c, p) not in column:
                    raise ValueError(f"no IO port {p!r} at {c}")
                index = self.in_index if p in drives else self.io_index
                index[c] = column[c, p]
        # fixpoint sweeps: longest register-free chain of the routed tree
        # (replaces the conservative len(route_edges) + 4 bound)
        self.depth = (depth if depth is not None
                      else fabric.depth_for_route(route_edges))

    @classmethod
    def from_pnr(cls, fabric: FabricModule, packed, result,
                 depth: Optional[int] = None) -> "AppEmulator":
        """Bind a PnRResult directly (packing-aware)."""
        with span("emu.bind"):
            pe_ops: Dict[Coord, Tuple[str, int]] = {}
            pe_imms: Dict[Coord, Dict[int, int]] = {}
            for name, inst in packed.placeable.items():
                if inst.kind != "pe":
                    continue
                xy = result.placement[name]
                pe_ops[xy] = (inst.op, inst.const)
                for port, val in packed.const_ports.get(name, {}).items():
                    pe_imms.setdefault(xy, {})[IMM_SLOTS[port]] = val
            io_ports: Dict[Coord, List[str]] = {}
            for net in packed.nets:
                for name, port in [net.src] + list(net.sinks):
                    inst = packed.placeable.get(name)
                    if inst is None or inst.kind not in ("io_in", "io_out"):
                        continue
                    io_ports.setdefault(tuple(result.placement[name]),
                                        []).append(
                        fabric_port(inst.kind, port))
            return cls(fabric, result.route_edges(), pe_ops, pe_imms,
                       depth=depth, io_ports=io_ports)

    def ext_stream(self, inputs: Dict[Tuple[int, int], np.ndarray],
                   cycles: int) -> np.ndarray:
        """Dense (cycles, num_io) drive matrix; streams longer than the
        emulation window are truncated. A port takes each word's low bits
        of its width (a 1-bit port the lowest)."""
        ext = np.zeros((cycles, self.fabric.num_io), np.int32)
        for coord, stream in inputs.items():
            stream = np.asarray(stream)[:cycles]
            col = self.in_index[coord]
            ext[:len(stream), col] = stream & self.fabric.io_in_mask[col]
        return ext

    def run(self, inputs: Dict[Tuple[int, int], np.ndarray], cycles: int
            ) -> Dict[Tuple[int, int], np.ndarray]:
        ext = self.ext_stream(inputs, cycles)
        obs = self.fabric.run(self.config, ext, pe_cfg=self.pe_cfg,
                              depth=self.depth).cpu().numpy()
        return {c: obs[:, i] for c, i in self.io_index.items()}


def run_apps_batch(emulators: Sequence[AppEmulator],
                   inputs_list: Sequence[Dict[Tuple[int, int], np.ndarray]],
                   cycles: int,
                   shard: Optional[bool] = None,
                   io_chunk: Optional[int] = None
                   ) -> List[Dict[Tuple[int, int], np.ndarray]]:
    """Emulate several routed applications on the *same* fabric as one
    batch: all configs/PE programs/IO streams advance together through a
    single ``FabricModule.run_batch`` (the fused batched kernel when the
    fabric was lowered with ``use_kernels=True``).

    Each app sweeps exactly its own routed combinational depth — lanes
    with shallower routes freeze early instead of padding to the batch
    max — so this is bit-identical to ``[e.run(i, cycles) for e, i in
    zip(...)]`` — the DSE bulk-evaluation path. ``shard`` forwards to
    ``run_batch`` (the batch split over the visible cards). ``io_chunk``
    forwards too: on the fused kernel engine the whole T-cycle emulation
    runs as one ``fabric_fused_run`` launch."""
    if not emulators:
        return []
    fab = emulators[0].fabric
    if any(e.fabric is not fab for e in emulators):
        raise ValueError("batched emulation requires a shared fabric")
    lanes = len(emulators)
    with span("emu.stage", lanes=lanes, cycles=cycles):
        ext = np.stack([e.ext_stream(i, cycles)
                        for e, i in zip(emulators, inputs_list)])  # (B,T,io)
        configs = torch.stack([e.config for e in emulators])
        pe_cfgs = {k: torch.stack([e.pe_cfg[k] for e in emulators])
                   for k in emulators[0].pe_cfg}
        depths = np.array([e.depth for e in emulators], dtype=np.int32)
    # the copy back waits for the card
    with span("emu.run", lanes=lanes, cycles=cycles):
        obs = fab.run_batch(configs, ext, pe_cfgs=pe_cfgs, depth=depths,
                            shard=shard, io_chunk=io_chunk).cpu().numpy()
    with span("emu.unpack", lanes=lanes):
        return [{c: obs[b, :, i] for c, i in e.io_index.items()}
                for b, e in enumerate(emulators)]

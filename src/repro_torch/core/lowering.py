"""Static-interconnect hardware backend (Canal §3.3), in PyTorch
(counterpart of repro/core/lowering.py).

Lowers the graph IR into a *functional PyTorch model* of the fabric
instead of magma RTL. The paper's three lowering rules are applied
mechanically:

1. nodes with hardware attributes (cores) generate the specified hardware —
   here, a vectorized functional model of the PE/MEM/IO cores;
2. directed edges become wires — here, entries in a gather table;
3. nodes with multiple incoming edges become multiplexers — here,
   config-indexed selects into the gather table.

Because the structural graph contains *potential* combinational cycles
(register-bypass muxes), the fabric evaluates each cycle by fixpoint
sweeps: one sweep propagates every node's value one combinational level.
A legal configuration's active network is acyclic, so ``depth`` sweeps
(≥ longest configured combinational path) reach the fixed point. The
sweep itself is the hot spot and has a kernel
(``repro_torch.kernels.fabric_step``); the batched path runs the whole
fixpoint — PE cores included — as one fused kernel launch per cycle, or
the whole T-cycle emulation as one launch with ``io_chunk``, and masks
each configuration to its own combinational depth. Where the cluster
kernels' shared-memory plan (``kernels/cluster_plan.py``, which the
ready-valid sweeps share) gives a lane a thread-block cluster, the lane's
values stay in its shared memory; past that they live in device memory.

The numpy table builders are the reference's, unchanged. With
``use_kernels=True`` every path (single sweep, unfused batched sweep,
fused fixpoint, streamed run) calls the kernel wrappers, which run the
CUDA kernels for a CUDA ``device`` and their plain versions on the CPU.
The single-configuration ``run`` stands in for the reference's
``lax.scan`` over a ``fori_loop``: on the card it replays each sweep from
a CUDA graph, so that the ~55 small launches of a sweep cost no host
time each.
"""
from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import span
from repro_torch.kernels.fabric_step import (PE_INPUTS, PE_OPS, PRED_OPS,
                                             pe_results)

from .graph import Interconnect, Node, NodeKind
from .tiles import (IO_BIT_IN, IO_BIT_OUT, PE_BIT_INPUTS, PE_BIT_OUTPUT,
                    IOCore, MemCore, PECore, WORD)

assert PECore.OPS == PE_OPS and PECore.PRED_OPS == PRED_OPS, \
    "fabric_step's op tables must mirror PECore's (shared PE ALU datapath)"
PE_OP_IDS = {op: i for i, op in enumerate(PECore.OPS)}
#: the predicate PE's ops, after ``PE_OP_IDS``: only a fabric with a
#: 1-bit layer (``FabricModule.pred``) runs them
PRED_OP_IDS = {op: len(PE_OP_IDS) + i for i, op in enumerate(PRED_OPS)}

DepthSpec = Union[int, np.ndarray, torch.Tensor]
State = Dict[str, torch.Tensor]


@dataclass
class ConfigSlot:
    node_id: int
    fanin: int
    num_bits: int
    # bitstream address (tile-feature-register, see repro_torch.core.bitstream)
    x: int
    y: int
    feature: str
    reg_index: int


@dataclass
class FabricArrays:
    """Dense tables driving the sweep evaluation. All numpy on the host;
    moved to the module's device on first use."""

    num_nodes: int
    max_fanin: int
    src: np.ndarray           # (N, F) int32, padded with N (zero sentinel)
    fanin_count: np.ndarray   # (N,) int32
    config_slot: np.ndarray   # (N,) int32, -1 when unconfigured
    is_reg: np.ndarray        # (N,) bool
    is_driven: np.ndarray     # (N,) bool: updated by sweeps
    reg_ids: np.ndarray       # (R,) node ids of registers
    reg_src: np.ndarray       # (R,) node id feeding each register
    num_config: int


class FabricModule:
    """Functional model of the generated interconnect + cores.

    ``step(state, ext_in, config, pe_cfg)`` advances one fabric clock
    cycle on ``device`` (``None``: the CUDA card). Node values are int32
    words masked to the layer bit width. ``use_kernels`` mirrors the
    reference's ``use_pallas``.
    """

    def __init__(self, ic: Interconnect, device: DeviceLike = None,
                 use_kernels: bool = False):
        self.ic = ic
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.nodes: List[Node] = list(ic.nodes())
        self.node_id: Dict[Node, int] = {n: i for i, n in
                                         enumerate(self.nodes)}
        self.config_slots: List[ConfigSlot] = []
        self._on_device: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}
        #: this fabric lowered on the other devices of a batch split
        self._replicas: Dict[torch.device, "FabricModule"] = {}
        self._build_tables()
        self._build_cores()

    # ------------------------------------------------------------------ build
    def _feature_of(self, node: Node) -> str:
        if node.kind == NodeKind.PORT:
            return f"CB_{node.port_name}"
        return "SB"

    def _build_tables(self) -> None:
        n = len(self.nodes)
        fanins = [len(node.fan_in) for node in self.nodes]
        max_f = max(1, max(fanins, default=1))
        src = np.full((n, max_f), n, dtype=np.int32)   # sentinel = n
        fanin_count = np.zeros(n, dtype=np.int32)
        config_slot = np.full(n, -1, dtype=np.int32)
        is_reg = np.zeros(n, dtype=bool)
        is_driven = np.zeros(n, dtype=bool)

        # per-(tile, feature) register index counter for bitstream addressing
        feat_counter: Dict[Tuple[int, int, str], int] = {}

        for i, node in enumerate(self.nodes):
            fi = len(node.fan_in)
            fanin_count[i] = fi
            for j, s in enumerate(node.fan_in):
                src[i, j] = self.node_id[s]
            if node.kind == NodeKind.REGISTER:
                is_reg[i] = True
                continue
            if fi >= 1:
                is_driven[i] = True
            if fi > 1:
                key = (node.x, node.y, self._feature_of(node))
                idx = feat_counter.get(key, 0)
                feat_counter[key] = idx + 1
                config_slot[i] = len(self.config_slots)
                self.config_slots.append(ConfigSlot(
                    node_id=i, fanin=fi,
                    num_bits=int(np.ceil(np.log2(fi))),
                    x=node.x, y=node.y, feature=key[2], reg_index=idx))

        reg_ids = np.array([i for i, node in enumerate(self.nodes)
                            if node.kind == NodeKind.REGISTER],
                           dtype=np.int32)
        reg_src = np.array([src[i, 0] for i in reg_ids], dtype=np.int32)

        self.arrays = FabricArrays(
            num_nodes=n, max_fanin=max_f, src=src, fanin_count=fanin_count,
            config_slot=config_slot, is_reg=is_reg, is_driven=is_driven,
            reg_ids=reg_ids, reg_src=reg_src,
            num_config=len(self.config_slots))
        self.width_mask = np.array(
            [(1 << node.width) - 1 for node in self.nodes] + [0],
            dtype=np.int32)

    def _build_cores(self) -> None:
        """Vectorized core models: PEs and IOs (MEM modeled as delay reg).

        Every layer materializes every core port; each port's node is the
        one in its own width's layer. With a 1-bit layer (``pred``) a PE
        reads data0-3 then bit0-2 (``pe_in`` (n_pe, 7)) and writes res0,
        res1 and res_p (``pe_out`` (n_pe, 3)), and each IO tile is two
        IO columns, its data pair first (every tile's) and its 1-bit pair
        after (``io_ports`` names each column's drive and observed
        ports)."""
        pe_in: List[List[int]] = []     # (n_pe, K) input port node ids
        pe_out: List[List[int]] = []    # (n_pe, O) output port node ids
        self.pe_coords: List[Tuple[int, int]] = []
        io_tiles: List[Tuple[int, int, object]] = []
        mem_in: List[int] = []
        mem_out: List[int] = []

        sentinel = self.arrays.num_nodes
        graphs = self.ic.graphs

        def port(x: int, y: int, core, name: str) -> int:
            width = next(p.width for p in core.ports if p.name == name)
            return self.node_id[graphs[width].get_port(x, y, name)]

        self.pred = False
        seen = set()
        for g in graphs.values():
            for (x, y), tile in sorted(g.tiles.items()):
                if tile.core is None or (x, y) in seen:
                    continue
                seen.add((x, y))
                core = tile.core
                if isinstance(core, PECore):
                    ins = [port(x, y, core, f"data{i}")
                           for i in range(core.num_inputs)]
                    ins = (ins + [sentinel] * (PE_INPUTS - len(ins))
                           )[:PE_INPUTS]
                    outs = [port(x, y, core, f"res{i}")
                            for i in range(core.num_outputs)]
                    if core.pred:
                        if core.num_outputs != 2:
                            raise ValueError(
                                "a PE with the 1-bit ports has res0 and "
                                "res1 beside res_p: pe_outputs must be 2, "
                                f"got {core.num_outputs}")
                        self.pred = True
                        ins += [port(x, y, core, p) for p in PE_BIT_INPUTS]
                        outs.append(port(x, y, core, PE_BIT_OUTPUT))
                    pe_in.append(ins)
                    pe_out.append(outs)
                    self.pe_coords.append((x, y))
                elif isinstance(core, IOCore):
                    io_tiles.append((x, y, core))
                elif isinstance(core, MemCore):
                    mem_in.append(port(x, y, core, "wdata"))
                    mem_out.append(port(x, y, core, "rdata"))
        io_pairs = [("io_out", "io_in")]    # (externally driven, observed)
        if any(p.name == IO_BIT_OUT for _, _, core in io_tiles
               for p in core.ports):
            io_pairs.append((IO_BIT_OUT, IO_BIT_IN))
        self.io_coords: List[Tuple[int, int]] = []
        #: each IO column's (externally driven, observed) port names
        self.io_ports: List[Tuple[str, str]] = []
        io_in_nodes: List[int] = []     # driven ports (io_out, io2f_1)
        io_out_nodes: List[int] = []    # observed ports (io_in, f2io_1)
        for pair in io_pairs:
            for x, y, core in io_tiles:
                io_in_nodes.append(port(x, y, core, pair[0]))
                io_out_nodes.append(port(x, y, core, pair[1]))
                self.io_coords.append((x, y))
                self.io_ports.append(pair)

        k_in = len(pe_in[0]) if pe_in else PE_INPUTS
        self.pe_in = np.array(pe_in, dtype=np.int32).reshape(-1, k_in)
        self.pe_out = (np.array(pe_out, dtype=np.int32)
                       if pe_out else np.zeros((0, 2), np.int32))
        #: each IO column's drive mask: its driven port's width
        self.io_in_mask = np.array(
            [self.width_mask[i] for i in io_in_nodes], np.int32)
        self.io_in_nodes = np.array(io_in_nodes, dtype=np.int32)
        self.io_out_nodes = np.array(io_out_nodes, dtype=np.int32)
        self.mem_in = np.array(mem_in, dtype=np.int32)
        self.mem_out = np.array(mem_out, dtype=np.int32)
        self.num_pe = len(pe_in)
        self.num_io = len(io_in_nodes)
        self.num_mem = len(mem_in)
        self._build_fused_tables()

    def _build_fused_tables(self) -> None:
        """Node/PE tables for the fused batched engine (one kernel call per
        fixpoint): hold-flags, pin mask, sentinel-padded PE inputs and the
        scatter-free node -> PE-result index map."""
        a = self.arrays
        n = a.num_nodes
        p = max(self.num_pe, 1)
        outs = 3 if self.pred else 2
        pe_in = np.full((p, self.pe_in.shape[1]), n, dtype=np.int32)
        if self.num_pe:
            pe_in[:self.num_pe] = self.pe_in
        pe_res_idx = np.full(n, outs * p, dtype=np.int32)
        for k in range(self.num_pe):
            for col in range(self.pe_out.shape[1]):
                pe_res_idx[self.pe_out[k, col]] = outs * k + col
        pin_mask = np.zeros(n, dtype=np.int32)
        if len(a.reg_ids):
            pin_mask[a.reg_ids] = 1
        if self.num_io:
            pin_mask[self.io_in_nodes] = 1
        if self.num_mem:
            pin_mask[self.mem_out] = 1
        # the single-configuration cycle re-pins these nodes from its
        # ``pins`` buffer, laid out [regs | ext io | mem]
        self.pin_ids = np.concatenate(
            [a.reg_ids, self.io_in_nodes, self.mem_out]).astype(np.int32)
        self.fused_tables = {
            "keep": (~a.is_driven).astype(np.int32),
            "pin_mask": pin_mask,
            "pe_in": pe_in,
            "pe_res_idx": pe_res_idx,
            "num_pe_slots": p,
        }
        self._stream_tables: Optional[Dict[str, np.ndarray]] = None

    def stream_tables(self) -> Dict[str, np.ndarray]:
        """Node tables for the streamed fused engine: the node → state
        gather map for scatter-free per-cycle re-pinning. State layout is
        ``[regs | ext io | mem | zero]``; every non-pinned node points at
        the trailing zero slot."""
        if self._stream_tables is None:
            a = self.arrays
            n_reg = len(a.reg_ids)
            s_len = n_reg + self.num_io + self.num_mem + 1
            pin_src = np.full(a.num_nodes, s_len - 1, dtype=np.int32)
            if n_reg:
                pin_src[a.reg_ids] = np.arange(n_reg, dtype=np.int32)
            if self.num_io:
                pin_src[self.io_in_nodes] = n_reg + np.arange(
                    self.num_io, dtype=np.int32)
            if self.num_mem:
                pin_src[self.mem_out] = n_reg + self.num_io + np.arange(
                    self.num_mem, dtype=np.int32)
            self._stream_tables = {
                "pin_src": pin_src,
                "reg_src": a.reg_src.astype(np.int32),
                "mem_in": self.mem_in.astype(np.int32),
                "io_out": self.io_out_nodes.astype(np.int32),
                "n_reg": n_reg,
            }
        return self._stream_tables

    # ------------------------------------------------------ device tables
    def _dev(self, name: str, arr: np.ndarray,
             dtype: torch.dtype = torch.int64) -> torch.Tensor:
        """A host table on this module's device, cached per name/dtype
        (int64 for indexing, int32 for the kernels)."""
        key = (name, dtype)
        t = self._on_device.get(key)
        if t is None:
            t = torch.as_tensor(np.ascontiguousarray(arr)).to(
                device=self.device, dtype=dtype)
            self._on_device[key] = t
        return t

    def _ints(self, x) -> torch.Tensor:
        """Caller data (tensor, array or list) as int32 on this device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.array(x, dtype=np.int32),
                               device=self.device)

    # -------------------------------------------------------------- interface
    @property
    def num_config(self) -> int:
        return self.arrays.num_config

    def _zeros(self, *shape: int) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def init_state(self) -> State:
        return {"regs": self._zeros(len(self.arrays.reg_ids)),
                "mem": self._zeros(max(self.num_mem, 1))}

    def init_state_batch(self, batch: int) -> State:
        """State for ``batch`` independent configurations (leading B dim)."""
        return {"regs": self._zeros(batch, len(self.arrays.reg_ids)),
                "mem": self._zeros(batch, max(self.num_mem, 1))}

    def default_pe_cfg(self) -> State:
        n = max(self.num_pe, 1)
        return {
            "op": torch.full((n,), PE_OP_IDS["add"], dtype=torch.int32,
                             device=self.device),
            "const": self._zeros(n),
            # per-port packed-constant immediates (packing stage, §3.4)
            "imm_mask": self._zeros(n, 4),
            "imm_val": self._zeros(n, 4),
        }

    def default_pe_cfg_batch(self, batch: int) -> State:
        one = self.default_pe_cfg()
        return {k: v.expand((batch,) + tuple(v.shape))
                for k, v in one.items()}

    # ------------------------------------------------------------- evaluation
    def _selects(self, configs: torch.Tensor) -> torch.Tensor:
        """Per-node mux selects for (B, num_config) configs -> (B, N):
        config value clipped to fan-in, 0 default."""
        a = self.arrays
        b = configs.shape[0]
        if a.num_config == 0:
            return self._zeros(b, a.num_nodes)
        slot = self._dev("config_slot", a.config_slot)
        cfg = configs.to(device=self.device, dtype=torch.int64)
        sel = torch.where(slot >= 0,
                          cfg[:, torch.clamp(slot, 0, a.num_config - 1)],
                          torch.zeros((), dtype=torch.int64,
                                      device=self.device))
        hi = torch.clamp(self._dev("fanin_count", a.fanin_count) - 1, min=0)
        return torch.minimum(torch.clamp(sel, min=0), hi).to(torch.int32)

    def _gather_batch(self, vals_ext: torch.Tensor,
                      sel: torch.Tensor) -> torch.Tensor:
        """Every node's selected input for B configurations, no hold:
        vals_ext (B, N+1) with the zero sentinel at N, sel (B, N) ->
        (B, N) — the ``fabric_sweep_batch`` kernel with ``use_kernels``
        (``core/verify.py``'s configuration sweep reads it directly)."""
        a = self.arrays
        if self.use_kernels:
            from repro_torch.kernels import ops as kops
            return kops.fabric_sweep_batch(
                vals_ext, self._dev("src", a.src, torch.int32), sel)
        rows = torch.arange(a.num_nodes, device=self.device)
        return torch.gather(vals_ext, 1,
                            self._dev("src", a.src)[rows[None, :],
                                                    sel.long()])

    def _sweep_batch(self, vals_ext: torch.Tensor,
                     sel: torch.Tensor) -> torch.Tensor:
        """Batched sweep: vals_ext (B, N+1), sel (B, N) -> (B, N)."""
        keep = self._dev("keep", ~self.arrays.is_driven, torch.bool)
        return torch.where(keep[None, :], vals_ext[:, :-1],
                           self._gather_batch(vals_ext, sel))

    def _pe_program(self, pe_cfg: State) -> State:
        """(B, ...) PE programs as ``_eval_pes`` reads them: ``op`` as the
        (1, B, P) int64 index of the candidate gather, ``const`` (B, P)
        and, where the program has them, the packed-constant immediates
        (``imm_mask`` as bool)."""
        npe = self.num_pe
        pe = {"op": pe_cfg["op"][:, :npe].long()[None],
              "const": pe_cfg["const"][:, :npe]}
        if "imm_mask" in pe_cfg:
            pe["imm_mask"] = pe_cfg["imm_mask"][:, :npe] > 0
            pe["imm_val"] = pe_cfg["imm_val"][:, :npe]
        return pe

    def _eval_pes(self, vals_ext: torch.Tensor, pe: State) -> None:
        """PE cores on (B, N+1) values, in place: each PE's outputs
        written from its inputs (sentinel-padded inputs read the zero at
        N) under a ``_pe_program``: res0 the ALU result, res1 data0
        passed through, res_p the result's low bit."""
        if self.num_pe == 0:
            return
        ins = vals_ext[:, self._dev("pe_in_raw", self.pe_in)]  # (B, P, K)
        res = pe_results(ins, pe.get("imm_mask"), pe.get("imm_val"),
                         pe["op"][0], pe["const"], WORD)
        out_ids = self._dev("pe_out", self.pe_out)
        for col in range(min(self.pe_out.shape[1], len(res))):
            vals_ext[:, out_ids[:, col]] = res[col]

    def _pin(self, v: torch.Tensor, state: State,
             ext_in: torch.Tensor) -> torch.Tensor:
        """Re-pin the sources of (B, N) values: registers, externally
        driven IO and memory reads."""
        a = self.arrays
        v = v.clone()
        if len(a.reg_ids):
            v[:, self._dev("reg_ids", a.reg_ids)] = state["regs"]
        if self.num_io:
            v[:, self._dev("io_in", self.io_in_nodes)] = ext_in.to(
                torch.int32)
        if self.num_mem:
            v[:, self._dev("mem_out", self.mem_out)] = \
                state["mem"][:, :self.num_mem]
        return v

    def _clock(self, vals: torch.Tensor, state: State
               ) -> Tuple[State, torch.Tensor]:
        """Next register / memory state and io observations from the
        settled (B, N) values."""
        a = self.arrays
        b = vals.shape[0]
        vals_ext = torch.cat([vals, self._zeros(b, 1)], dim=1)
        new_state = dict(state)
        if len(a.reg_ids):
            new_state["regs"] = vals_ext[:, self._dev("reg_src", a.reg_src)]
        if self.num_mem:
            mem = state["mem"].clone()
            mem[:, :self.num_mem] = vals_ext[:, self._dev("mem_in",
                                                          self.mem_in)]
            new_state["mem"] = mem
        io_obs = (vals_ext[:, self._dev("io_out", self.io_out_nodes)]
                  if self.num_io else self._zeros(b, 0))
        return new_state, io_obs

    # ---------------------------------------- the single-configuration cycle
    def _cycle(self, config, pe_cfg: Optional[State]) -> State:
        """The buffers of single-configuration cycles: what the
        configuration fixes for a run (the mux selects ``sel`` and, off
        the kernel path, each node's selected source ``picked``; the PE
        program ``pe``), the sources' values ``pins`` ([regs | ext io |
        mem], zero as in ``init_state``) and the two (N+1,) value vectors
        ``vals`` that a cycle's sweeps alternate between (the zero
        sentinel at N; two tensors, so that each starts 16-B aligned for
        the kernel's vector loads)."""
        n = self.arrays.num_nodes
        pe_cfg = self.default_pe_cfg() if pe_cfg is None else pe_cfg
        cyc = {"sel": self._selects(self._ints(config)[None])[0],
               "pe": self._pe_program({k: self._ints(v)[None]
                                       for k, v in pe_cfg.items()}),
               "pins": self._zeros(len(self.pin_ids)),
               "vals": (self._zeros(n + 1), self._zeros(n + 1))}
        if not self.use_kernels:
            rows = torch.arange(n, device=self.device)
            cyc["picked"] = self._dev("src", self.arrays.src)[
                rows, cyc["sel"].long()]
        return cyc

    def _start_cycle(self, cyc: State, vals: torch.Tensor) -> None:
        """A cycle's first values: the pinned sources on zeros."""
        vals.zero_()
        vals.index_copy_(0, self._dev("pin_ids", self.pin_ids), cyc["pins"])

    def _sweep(self, cyc: State, cur: torch.Tensor,
               nxt: torch.Tensor) -> None:
        """One fixpoint sweep from ``cur`` into ``nxt`` (both (N+1,); the
        sentinel stays 0), the reference's ``fori_loop`` body: every
        node's selected input (the ``fabric_sweep`` kernel with
        ``use_kernels``), undriven nodes held, the sources re-pinned, the
        PE cores evaluated. In place on the cycle's buffers, so that a
        CUDA graph of it replays on them."""
        a = self.arrays
        n = a.num_nodes
        new = nxt[:n]
        if self.use_kernels:
            from repro_torch.kernels import ops as kops
            kops.fabric_sweep(cur, self._dev("src", a.src, torch.int32),
                              cyc["sel"], out=new)
        else:
            torch.index_select(cur, 0, cyc["picked"], out=new)
        torch.where(self._dev("keep", ~a.is_driven, torch.bool), cur[:n],
                    new, out=new)
        nxt.index_copy_(0, self._dev("pin_ids", self.pin_ids), cyc["pins"])
        self._eval_pes(nxt[None], cyc["pe"])

    def _clock_cycle(self, cyc: State, vals: torch.Tensor,
                     obs: torch.Tensor) -> None:
        """From a cycle's settled (N+1,) values: the io observations into
        ``obs``, the next registers and memory words into ``pins``."""
        r, io = len(self.arrays.reg_ids), self.num_io
        pins = cyc["pins"]
        torch.index_select(vals, 0, self._dev("io_out", self.io_out_nodes),
                           out=obs)
        torch.index_select(vals, 0, self._dev("reg_src", self.arrays.reg_src),
                           out=pins[:r])
        torch.index_select(vals, 0, self._dev("mem_in", self.mem_in),
                           out=pins[r + io:])

    def _eager_cycle(self, cyc: State, depth: int, obs: torch.Tensor
                     ) -> None:
        """One clock cycle, sweep by sweep."""
        vals = cyc["vals"]
        self._start_cycle(cyc, vals[0])
        for k in range(depth):
            self._sweep(cyc, vals[k % 2], vals[(k + 1) % 2])
        self._clock_cycle(cyc, vals[depth % 2], obs)

    def _eager_cycles(self, cyc: State, ext: torch.Tensor, depth: int,
                      out: torch.Tensor) -> None:
        """``run``'s cycles sweep by sweep (off the card's kernel path):
        (T, num_io) stimulus -> observations into ``out``."""
        r, io = len(self.arrays.reg_ids), self.num_io
        for t in range(ext.shape[0]):
            cyc["pins"][r:r + io].copy_(ext[t])
            self._eager_cycle(cyc, depth, out[t])

    def _graphed_cycles(self, cyc: State, ext: torch.Tensor, depth: int,
                        out: torch.Tensor) -> None:
        """``run``'s cycles on the card: the sweep captured into one CUDA
        graph per direction (``vals[0]`` -> ``vals[1]`` and back), each
        cycle's ``depth`` sweeps replayed from them. The run's first sweep
        runs eagerly, on a side stream, before the capture, so that every
        device table and the kernel library exist; each replay counts one
        ``fabric_sweep`` launch. A failed capture or replay raises."""
        from repro_torch.kernels import build

        r, io = len(self.arrays.reg_ids), self.num_io
        vals = cyc["vals"]
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        cyc["pins"][r:r + io].copy_(ext[0])
        self._start_cycle(cyc, vals[0])
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._sweep(cyc, vals[0], vals[1])
        stream.wait_stream(side)
        graphs = []
        for cur, nxt in (vals, vals[::-1]):
            graph = torch.cuda.CUDAGraph()
            # other threads (the DSE executor's) may use the card meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._sweep(cyc, cur, nxt)
            graphs.append(graph)
        for t in range(ext.shape[0]):
            if t:
                cyc["pins"][r:r + io].copy_(ext[t])
                self._start_cycle(cyc, vals[0])
            first = 1 if t == 0 else 0
            for k in range(first, depth):
                graphs[k % 2].replay()
            build.count_launch("fabric_sweep", depth - first)
            self._clock_cycle(cyc, vals[depth % 2], out[t])

    def step(self, state: State, ext_in, config,
             pe_cfg: Optional[State] = None,
             depth: int = 16) -> Tuple[State, torch.Tensor]:
        """One fabric clock cycle (one sweep launch per fixpoint sweep).

        state: registers/mem. ext_in: (num_io,) values driven onto io_out
        ports. config: (num_config,) mux selects. Returns (state', io_out
        observations). ``depth`` = fixpoint sweeps (≥ longest configured
        combinational chain).
        """
        r, io = len(self.arrays.reg_ids), self.num_io
        cyc = self._cycle(config, pe_cfg)
        torch.cat([self._ints(state["regs"]), self._ints(ext_in),
                   self._ints(state["mem"])[:self.num_mem]], out=cyc["pins"])
        obs = self._zeros(io)
        self._eager_cycle(cyc, depth, obs)
        new_state = dict(state)
        new_state["regs"] = cyc["pins"][:r]
        if self.num_mem:
            new_state["mem"] = self._ints(state["mem"]).clone()
            new_state["mem"][:self.num_mem] = cyc["pins"][r + io:]
        return new_state, obs

    def run(self, config, ext_stream,
            pe_cfg: Optional[State] = None,
            depth: Optional[int] = None) -> torch.Tensor:
        """Run T cycles; ext_stream (T, num_io) -> observations (T, num_io).

        ``depth=None`` computes the per-config combinational depth from the
        configured network (host-side). On the card with ``use_kernels``
        the sweeps replay from a CUDA graph captured once per call; the
        result is the sweep-by-sweep loop's, bit for bit."""
        if depth is None:
            depth = self.combinational_depth(np.asarray(
                config.cpu() if isinstance(config, torch.Tensor) else config))
        ext = self._ints(ext_stream)
        out = self._zeros(ext.shape[0], self.num_io)
        cyc = self._cycle(config, pe_cfg)
        if (self.device.type == "cuda" and self.use_kernels and depth > 0
                and ext.shape[0]):
            self._graphed_cycles(cyc, ext, depth, out)
        else:
            self._eager_cycles(cyc, ext, depth, out)
        return out

    def _norm_depth(self, depth: DepthSpec, max_depth: Optional[int],
                    b: int) -> Tuple[torch.Tensor, int]:
        """Normalize a depth spec into ((B,) per-lane sweep counts,
        loop bound)."""
        if isinstance(depth, (int, np.integer)):
            md = int(depth) if max_depth is None else int(max_depth)
            return torch.full((b,), int(depth), dtype=torch.int32,
                              device=self.device), md
        depths = self._ints(depth)
        if max_depth is None:
            max_depth = int(depths.max()) if b else 1
        return depths, int(max_depth)

    def _norm_pe_cfg(self, pe_cfg: State, b: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
        """PE program tables shaped for the fused kernel: (B, P) op/const
        and (B, P, 4) immediates, P = max(num_pe, 1) slots."""
        p = self.fused_tables["num_pe_slots"]
        npe = self.num_pe

        def padded(key, shape):
            out = self._zeros(b, p, *shape)
            if key in pe_cfg:
                out[:, :npe] = self._ints(pe_cfg[key])[:, :npe]
            return out

        return (padded("op", ()), padded("const", ()),
                padded("imm_mask", (4,)), padded("imm_val", (4,)))

    def _fused_args(self) -> Dict[str, torch.Tensor]:
        t = self.fused_tables
        return {"src": self._dev("src", self.arrays.src, torch.int32),
                "keep": self._dev("keep", t["keep"], torch.int32),
                "pin_mask": self._dev("pin_mask", t["pin_mask"], torch.int32),
                "pe_in": self._dev("pe_in", t["pe_in"], torch.int32),
                "pe_res_idx": self._dev("pe_res_idx", t["pe_res_idx"],
                                        torch.int32)}

    def step_batch(self, state: State, ext_in, config,
                   pe_cfg: Optional[State] = None,
                   depth: DepthSpec = 16,
                   max_depth: Optional[int] = None,
                   fused: Optional[bool] = None
                   ) -> Tuple[State, torch.Tensor]:
        """One fabric clock cycle for B configurations at once.

        Every argument carries a leading batch dim: state regs (B, R) /
        mem (B, M), ext_in (B, num_io), config (B, num_config), pe_cfg
        leaves (B, ...). Returns (state', (B, num_io) observations).

        ``depth`` is either a shared int or a (B,) per-configuration sweep
        count: every lane runs the ``max_depth`` loop but freezes once its
        own count is reached. ``fused`` (default True) runs the whole
        fixpoint — PE evaluation included — as one call
        (``fabric_fused_batch`` with ``use_kernels``, the scatter-based
        oracle otherwise); ``fused=False`` keeps the sweep-at-a-time loop
        as the unfused baseline."""
        config = self._ints(config)
        b = config.shape[0]
        pe_cfg = (self.default_pe_cfg_batch(b) if pe_cfg is None else
                  {k: self._ints(v) for k, v in pe_cfg.items()})
        if fused is None:
            fused = True
        a = self.arrays
        depths, max_depth = self._norm_depth(depth, max_depth, b)
        sel = self._selects(config)                    # (B, N)
        ext_in = self._ints(ext_in)
        # pinned sources on a zero background double as the initial values
        pin_vals = self._pin(self._zeros(b, a.num_nodes), state, ext_in)

        if fused:
            op, const, imm_mask, imm_val = self._norm_pe_cfg(pe_cfg, b)
            t = self._fused_args()
            if self.use_kernels:
                from repro_torch.kernels import ops as kops
                vals = kops.fabric_fused_batch(
                    pin_vals, sel, pin_vals, depths, op, const, imm_mask,
                    imm_val, t["src"], t["keep"], t["pin_mask"], t["pe_in"],
                    t["pe_res_idx"], max_depth=max_depth, word=WORD)
            else:
                from repro_torch.kernels import ref as kref
                # no kernel, so no cluster holds a lane (as the kernel
                # wrappers' own spans record it)
                with span("emu.fused", cluster=0, room=0, nodes=a.num_nodes,
                          kernel=False):
                    vals = kref.fabric_fused_batch_ref(
                        pin_vals, sel, pin_vals, depths, op, const,
                        imm_mask, imm_val, t["src"], t["keep"],
                        t["pin_mask"], t["pe_in"],
                        self._dev("pe_out", self.pe_out),
                        max_depth=max_depth, word=WORD)
        else:
            pe = self._pe_program(pe_cfg)
            vals = pin_vals
            zero = self._zeros(b, 1)
            for i in range(max_depth):
                v_ext = torch.cat([vals, zero], dim=1)
                nv = torch.cat([self._pin(self._sweep_batch(v_ext, sel),
                                          state, ext_in), zero], dim=1)
                self._eval_pes(nv, pe)
                vals = torch.where((i < depths)[:, None], nv[:, :-1], vals)
        return self._clock(vals, state)

    def _run_batch_stream(self, configs: torch.Tensor, ext: torch.Tensor,
                          pe_cfgs: State, depths: torch.Tensor,
                          max_depth: int, io_chunk: int) -> torch.Tensor:
        """Streamed fused engine: the whole T-cycle emulation in one
        kernel launch (``fabric_fused_run``). Bit-identical to the
        per-cycle loop."""
        from repro_torch.kernels import ops as kops

        b = configs.shape[0]
        sel = self._selects(configs)
        op, const, imm_mask, imm_val = self._norm_pe_cfg(pe_cfgs, b)
        t = self._fused_args()
        s = self.stream_tables()
        return kops.fabric_fused_run(
            sel, ext, depths, op, const, imm_mask, imm_val, t["src"],
            t["keep"], t["pin_mask"],
            self._dev("pin_src", s["pin_src"], torch.int32),
            t["pe_in"], t["pe_res_idx"],
            self._dev("reg_src", s["reg_src"], torch.int32),
            self._dev("mem_in", s["mem_in"], torch.int32),
            self._dev("io_out", s["io_out"], torch.int32),
            n_reg=s["n_reg"], n_io=self.num_io, n_mem=self.num_mem,
            max_depth=max_depth, chunk=io_chunk, word=WORD)

    def _run_batch_local(self, configs: torch.Tensor, ext: torch.Tensor,
                         pe_cfgs: State, depths: torch.Tensor,
                         max_depth: int, fused: Optional[bool],
                         io_chunk: Optional[int] = None) -> torch.Tensor:
        """Loop T cycles over a batch of configurations — or, with
        ``io_chunk`` on the fused kernel engine, one streamed multi-cycle
        launch."""
        if io_chunk and self.use_kernels and (fused is None or fused):
            return self._run_batch_stream(configs, ext, pe_cfgs, depths,
                                          max_depth, io_chunk)
        b = configs.shape[0]
        state = self.init_state_batch(b)
        outs = []
        for t in range(ext.shape[1]):
            state, obs = self.step_batch(state, ext[:, t], configs, pe_cfgs,
                                         depth=depths, max_depth=max_depth,
                                         fused=fused)
            outs.append(obs)
        if not outs:
            return self._zeros(b, 0, self.num_io)
        return torch.stack(outs, dim=1)                 # (B, T, io)

    def run_batch(self, configs, ext_streams,
                  pe_cfgs: Optional[State] = None,
                  depth: Optional[DepthSpec] = None,
                  fused: Optional[bool] = None,
                  shard: Optional[bool] = None,
                  io_chunk: Optional[int] = None,
                  _devices: Optional[Sequence[torch.device]] = None
                  ) -> torch.Tensor:
        """Evaluate B configurations together.

        configs: (B, num_config); ext_streams: (B, T, num_io); pe_cfgs
        leaves (B, ...). Returns (B, T, num_io) observations — the batched
        equivalent of looping ``run`` over the B axis, bit-identical to it
        lane for lane. ``depth=None`` computes every configuration's own
        combinational depth on the host; a lane freezes once its own count
        is reached, so even an adversarial config with a combinational
        loop sees exactly the sweeps its per-config ``run`` would.

        ``io_chunk`` runs the whole emulation as one ``fabric_fused_run``
        launch (requires ``use_kernels`` and the fused engine; ignored
        otherwise), bit-identical to the per-cycle loop.

        ``shard`` splits the batch over the devices of
        :meth:`_split_devices` (every CUDA card for a CUDA module):
        ``None`` splits whenever there is more than one, ``True`` too,
        ``False`` keeps the batch on this module's device. The split pads
        B to a multiple of the device count (zero configurations at depth
        0), runs each chunk on the fabric lowered on its device, all
        chunks at once, and returns the first B rows on this module's
        device: bit-identical to the local run. ``_devices`` hands the
        split an explicit device list (the probe names one device
        several times)."""
        configs = self._ints(configs)
        ext = self._ints(ext_streams)
        b = configs.shape[0]
        if depth is None:
            host_cfgs = configs.cpu().numpy()
            depths_np = np.array(
                [self.combinational_depth(c) for c in host_cfgs],
                dtype=np.int32) if b else np.zeros(0, np.int32)
        else:
            d = depth.cpu().numpy() if isinstance(depth, torch.Tensor) \
                else depth
            depths_np = np.broadcast_to(np.asarray(d, np.int32), (b,))
        max_depth = int(depths_np.max()) if b else 1
        if pe_cfgs is None:
            pe_cfgs = self.default_pe_cfg_batch(b)
        devices = self._split_devices(_devices)
        use_shard = (len(devices) > 1) if shard is None else shard
        if not use_shard or len(devices) <= 1 or b == 0:
            return self._run_batch_local(configs, ext, pe_cfgs,
                                         self._ints(depths_np), max_depth,
                                         fused, io_chunk)
        return self._run_batch_split(devices, configs, ext, pe_cfgs,
                                     depths_np, max_depth, fused, io_chunk)

    def _split_devices(self, devices: Optional[Sequence[torch.device]] = None
                       ) -> List[torch.device]:
        """The devices ``run_batch`` splits a batch over: ``devices``
        when given, else every CUDA card for a CUDA module and this
        module's own device otherwise."""
        if devices is not None:
            return [torch.device(d) for d in devices]
        if self.device.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [self.device]

    def _on(self, device: torch.device) -> "FabricModule":
        """This fabric lowered on ``device``: the same host tables, its
        own cache of device tables (``_dev``); this module itself for its
        own device."""
        def indexed(d: torch.device) -> torch.device:
            if d.type == "cuda" and d.index is None:
                return torch.device("cuda", torch.cuda.current_device())
            return d

        device = indexed(device)
        if device == indexed(self.device):
            return self
        fab = self._replicas.get(device)
        if fab is None:
            fab = copy.copy(self)
            fab.device = device
            fab._on_device = {}
            fab._replicas = {}
            fab = self._replicas.setdefault(device, fab)
        return fab

    def _run_batch_split(self, devices: List[torch.device],
                         configs: torch.Tensor, ext: torch.Tensor,
                         pe_cfgs: State, depths_np: np.ndarray,
                         max_depth: int, fused: Optional[bool],
                         io_chunk: Optional[int]) -> torch.Tensor:
        """``run_batch`` over ``devices``: one chunk of the padded batch
        a device, each in its own thread (and, on a card, its own stream)
        so that the chunks run at once; the rows come back in order."""
        n_dev, b = len(devices), configs.shape[0]
        per = -(-b // n_dev)                            # ceil to devices
        pad = per * n_dev - b

        def pad_b(x: torch.Tensor) -> torch.Tensor:
            x = self._ints(x)
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

        configs, ext = pad_b(configs), pad_b(ext)
        pe_cfgs = {k: pad_b(v) for k, v in pe_cfgs.items()}
        depths = self._ints(np.pad(depths_np, (0, pad)))
        caller = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def chunk(i: int) -> torch.Tensor:
            fab, sl = self._on(devices[i]), slice(i * per, (i + 1) * per)

            def run() -> torch.Tensor:
                return fab._run_batch_local(
                    fab._ints(configs[sl]), fab._ints(ext[sl]),
                    {k: fab._ints(v[sl]) for k, v in pe_cfgs.items()},
                    fab._ints(depths[sl]), max_depth, fused,
                    io_chunk).to(self.device)

            if fab.device.type != "cuda":
                return run()
            with torch.cuda.device(fab.device):
                side = torch.cuda.Stream()
                if caller is not None:
                    side.wait_stream(caller)
                with torch.cuda.stream(side):
                    out = run()
                side.synchronize()
            if caller is not None:
                out.record_stream(caller)
            return out

        with ThreadPoolExecutor(max_workers=n_dev,
                                thread_name_prefix="run-batch") as pool:
            outs = list(pool.map(chunk, range(n_dev)))
        return torch.cat(outs)[:b]

    # ------------------------------------------------- combinational depth
    def _selected_src_host(self, config: np.ndarray) -> np.ndarray:
        """Host-side selected source per node under ``config`` (N,)."""
        a = self.arrays
        sel = np.zeros(a.num_nodes, np.int64)
        mask = a.config_slot >= 0
        if a.num_config:
            cfg = np.asarray(config, np.int64)
            sel[mask] = cfg[a.config_slot[mask]]
        sel = np.clip(sel, 0, np.maximum(a.fanin_count - 1, 0))
        return a.src[np.arange(a.num_nodes), sel]

    def combinational_depth(self, config: np.ndarray,
                            margin: int = 1) -> int:
        """Sweeps needed to reach the fixpoint under ``config``: longest
        register-free chain of the *configured* network (each mux follows
        only its selected input), instead of the conservative fixed bound.

        Chains are rooted at pinned nodes (registers, externally driven IO,
        memory outputs, undriven nodes); a PE output sits one level above
        its deepest input. A legal configuration's active network is
        acyclic; combinational cycles through unconfigured default-0 muxes
        are detected and excluded (their values never stabilize and no
        routed path goes through them)."""
        a = self.arrays
        n = a.num_nodes
        src_sel = self._selected_src_host(config)
        pinned = (~a.is_driven) | a.is_reg
        if len(self.io_in_nodes):
            pinned[self.io_in_nodes] = True
        if len(self.mem_out):
            pinned[self.mem_out] = True
        derive = ~pinned
        depth = np.zeros(n + 1, np.int64)       # sentinel at n stays 0
        prev_changed: Optional[np.ndarray] = None
        cap = min(n + 2, 4096)
        for _ in range(cap):
            new = depth.copy()
            new[:n][derive] = depth[src_sel[derive]] + 1
            if self.num_pe:
                pe_depth = depth[self.pe_in].max(axis=1) + 1   # (n_pe,)
                for col in range(self.pe_out.shape[1]):
                    new[self.pe_out[:, col]] = pe_depth
            new[n] = 0
            changed = np.nonzero(new != depth)[0]
            depth = new
            if changed.size == 0:
                return int(depth.max()) + margin
            if (prev_changed is not None
                    and np.array_equal(changed, prev_changed)):
                # a set equal to its own successor set contains a cycle:
                # report the depth of the stable (acyclic) portion only
                stable = np.ones(n + 1, bool)
                stable[changed] = False
                d = int(depth[stable].max()) if stable.any() else 0
                return max(d + margin, 1)
            prev_changed = changed
        return cap

    def depth_for_route(self, edges: Sequence[Tuple[Node, Node]],
                        margin: int = 2) -> int:
        """Sweeps needed to emulate a routed application: longest
        register-free chain along the routed tree (PE core hops included),
        replacing the conservative ``len(edges) + 4`` bound."""
        sentinel = self.arrays.num_nodes
        is_reg = self.arrays.is_reg
        children: Dict[int, List[Tuple[int, int]]] = {}
        indeg: Dict[int, int] = {}
        nodes = set()

        def add_edge(u: int, v: int, w: int) -> None:
            children.setdefault(u, []).append((v, w))
            indeg[v] = indeg.get(v, 0) + 1
            nodes.add(u)
            nodes.add(v)

        for s, d in edges:
            add_edge(self.node_id[s], self.node_id[d], 1)
        # PE core hops are weight 0: _eval_pes runs after the gather, so a
        # PE output settles in the same sweep as its inputs
        for k in range(self.num_pe):
            ins = [int(i) for i in self.pe_in[k] if i != sentinel]
            for col in range(self.pe_out.shape[1]):
                out = int(self.pe_out[k, col])
                for i in ins:
                    add_edge(i, out, 0)
        # longest path over the routed DAG; registers restart the chain
        depth = {i: 0 for i in nodes}
        ready = [i for i in nodes if indeg.get(i, 0) == 0]
        seen = 0
        while ready:
            u = ready.pop()
            seen += 1
            du = 0 if is_reg[u] else depth[u]
            for v, w in children.get(u, ()):
                if not is_reg[v]:
                    depth[v] = max(depth[v], du + w)
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if seen != len(nodes):
            # combinational loop through a PE (route feeds the PE its own
            # output): fall back to the conservative bound
            return len(list(edges)) + 4
        return max(depth.values(), default=0) + margin

    # ------------------------------------------------------- route → config
    def route_to_config(self, edges: Sequence[Tuple[Node, Node]]
                        ) -> np.ndarray:
        """Translate routed IR edges into a config vector: for every edge
        (src → dst) where dst is a mux, set dst's select to src's input
        index. Conflicting assignments raise (illegal route)."""
        config = np.zeros(self.num_config, dtype=np.int32)
        assigned: Dict[int, int] = {}
        for src, dst in edges:
            i = self.node_id[dst]
            slot = self.arrays.config_slot[i]
            if slot < 0:
                continue                    # single-input: hardwired
            sel = dst.fan_in.index(src)
            if i in assigned and assigned[i] != sel:
                raise ValueError(
                    f"conflicting mux assignment at {dst}: "
                    f"{assigned[i]} vs {sel}")
            assigned[i] = sel
            config[slot] = sel
        return config

    def structural_connectivity(self) -> Dict[Tuple, List[Tuple]]:
        """Connectivity as realized by the lowered tables — compared against
        the IR by repro.core.verify (paper: parse generated RTL)."""
        out: Dict[Tuple, List[Tuple]] = {}
        a = self.arrays
        for i, node in enumerate(self.nodes):
            keys = []
            for j in range(a.fanin_count[i]):
                keys.append(self.nodes[a.src[i, j]].node_key())
            out[node.node_key()] = keys
        return out


def compile_interconnect(ic: Interconnect, device: DeviceLike = None,
                         use_kernels: bool = False) -> FabricModule:
    """The static-backend entry point (IR → hardware, §3.3)."""
    with span("ir.lower"):
        return FabricModule(ic, device=device, use_kernels=use_kernels)

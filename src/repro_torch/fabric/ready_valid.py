"""Ready-valid (statically configured NoC) backend — Canal §3.3,
Figs. 5–6 (counterpart of repro/fabric/ready_valid.py).

Same IR, different lowering:

* **valid** flows with the data: identical gather network, 1-bit values.
* **ready** flows *backwards*; at every fan-in point the joining logic
  reuses the data mux's one-hot select (Fig. 5): the ready contribution of
  consumer ``d`` to producer ``n`` is ``R(d) OR (sel(d) != index(n))`` —
  i.e. high when ``d`` is ready *or* the route through ``d`` does not use
  ``n``. Producer ready is the AND over all consumers. No LUTs.
* **registers become FIFOs**. Two modes (Fig. 6 / Fig. 8):
  - ``full``: every register node is a depth-2 FIFO with *registered*
    occupancy-based ready (cuts the control timing path; +54% SB area);
  - ``split``: each register keeps its single slot, and the *chain* of two
    adjacent single-slot stages behaves as one depth-2 FIFO. Ready is
    pop-aware (``~occ OR popping``), i.e. a combinational control chain —
    exactly the paper's noted drawback (unregistered control at tile
    boundaries) in exchange for +32% instead of +54% area.

A cycle is a synchronous two-phase evaluation: forward fixpoint sweeps
for (data, valid), backward fixpoint sweeps for ready, then the FIFO
push/pop state update. The two phases are independent within a cycle
(ready reads only the selects, the occupancy and the sinks).

The configuration is fixed for a run, so each node's selected source and
each consumer's "uses this producer" flag are computed once: a forward
sweep is a gather from the selected sources, and a backward sweep a
min-gather over the used consumers (an unused one reads the always-ready
sentinel). Both sweeps work in place on preallocated buffers. A run's
sweeps take one of two paths. On the card with ``use_kernels``, where the
cluster kernels' shared-memory plan gives the fabric a cluster
(``kernels/rv_sweep.py:rv_plan``: up to 16 blocks, N + 1 <= 232,448), a
cycle's sweeps are one launch of the ``rv_sweeps`` kernel. Everywhere
else (the CPU, ``use_kernels=False``, a larger fabric) the same sweep
functions run eagerly. The drive and the FIFO update stay a short eager
tail.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import IO, Interconnect, Node, NodeKind, Side
from repro_torch.core.lowering import FabricModule, State
from repro_torch.core.tiles import WORD
from repro_torch.device import DeviceLike
from repro_torch.kernels.rv_sweep import rv_plan, rv_sweeps, rv_tables
from repro_torch.obs import span

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class RVFabric(FabricModule):
    """Hybrid ready-valid interconnect functional model."""

    def __init__(self, ic: Interconnect, fifo_mode: str = "split",
                 device: DeviceLike = None, use_kernels: bool = False):
        if fifo_mode not in ("full", "split"):
            raise ValueError("fifo_mode must be 'full' or 'split'")
        self.fifo_mode = fifo_mode
        self.fifo_depth = 2 if fifo_mode == "full" else 1
        super().__init__(ic, device=device, use_kernels=use_kernels)
        if self.pred:
            raise ValueError(
                "the ready-valid fabric models the data layer's PEs only: "
                "an interconnect with a 1-bit layer (its PEs' bit0-2 and "
                "res_p, its IOs' 1-bit pair) has no ready-valid lowering")
        self._build_reverse_tables()
        #: always 0 (no path replays CUDA graphs): kept because
        #: ``canalbench/kinds/rv_stream.py`` reads it into
        #: ``rv_sweep_launches_per_cycle``
        self.graph_replays = 0
        #: cycles whose sweeps the ``rv_sweeps`` kernel ran so far
        self.kernel_cycles = 0
        #: the state after the last ``run_stream`` / ``run_with_sources``
        self.last_state: Optional[State] = None

    # ------------------------------------------------------------------ build
    def _build_reverse_tables(self) -> None:
        a = self.arrays
        n = a.num_nodes
        cons_lists: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
        for i, node in enumerate(self.nodes):
            for j, srcn in enumerate(node.fan_in):
                cons_lists[self.node_id[srcn]].append((i, j))
        max_c = max(1, max((len(c) for c in cons_lists), default=1))
        # consumer node id, padded with n (sentinel: always-ready consumer)
        cons = np.full((n, max_c), n, dtype=np.int32)
        cons_idx = np.zeros((n, max_c), dtype=np.int32)
        for i, lst in enumerate(cons_lists):
            for k, (ci, cj) in enumerate(lst):
                cons[i, k] = ci
                cons_idx[i, k] = cj
        self.cons = cons
        self.cons_idx = cons_idx
        self.max_cons = max_c
        self.is_reg_arr = a.is_reg.copy()
        # map node id -> register slot index
        self.reg_slot = np.full(n, -1, dtype=np.int32)
        for r, i in enumerate(a.reg_ids):
            self.reg_slot[i] = r
        # PE valid is written output column by column (res0, then res1);
        # every output port is its own node, so the order cannot matter
        outs = self.pe_out.ravel()
        if len(np.unique(outs)) != len(outs):
            raise ValueError("PE output ports must be distinct nodes")
        # the forward pass pins register heads and externally driven IO
        # (laid out [regs | ext io]); memory outputs stay undriven
        self.rv_pin_ids = np.concatenate(
            [a.reg_ids, self.io_in_nodes]).astype(np.int32)
        # PE a/b valid inputs into the (N + 2,) valid buffer, whose slot
        # N + 1 holds the 1 an absent input reads
        self.pe_valid_in = np.where(self.pe_in[:, :2] == n, n + 1,
                                    self.pe_in[:, :2]).astype(np.int32)

    # -------------------------------------------------------------- interface
    def init_state(self) -> State:
        r = len(self.arrays.reg_ids)
        return {"slots": self._zeros(r, 2),          # FIFO storage
                "occ": self._zeros(r),               # occupancy
                "mem": self._zeros(max(self.num_mem, 1))}

    # ------------------------------------------------------- one run's buffers
    def _rv_cycle(self, config, pe_cfg: Optional[State]) -> State:
        """What the configuration fixes for a run and the buffers its
        cycles sweep in place: each node's selected source ``picked``,
        each node's used consumers ``cons_used`` (an unused or absent one
        is the sentinel N, which reads ready), the PE program ``pe``, the
        pinned values ``pins_d`` / ``pins_v`` ([regs | ext io]), the
        backward pass's pinned ready ``fix_mask`` / ``fix_val``, and two
        of each sweep buffer: data (N+1,) with 0 at N, valid (N+2,) with 0
        at N and 1 at N+1, ready (N+1,) with 1 at N."""
        a = self.arrays
        n = a.num_nodes
        pe_cfg = self.default_pe_cfg() if pe_cfg is None else pe_cfg
        sel = self._selects(self._ints(config)[None])[0]
        rows = torch.arange(n, device=self.device)
        cons = self._dev("cons", self.cons)
        s_ext = torch.cat([sel, self._zeros(1)])
        cons_idx = self._dev("cons_idx", self.cons_idx, torch.int32)
        used = (s_ext[cons] == cons_idx) & (cons < n)
        cons_used = torch.where(used, cons, torch.full_like(cons, n))

        def buffers(length: int, tail: List[int]) -> Tuple[torch.Tensor, ...]:
            out = []
            for _ in range(2):
                t = self._zeros(length)
                for k, val in enumerate(tail):
                    t[n + k] = val
                out.append(t)
            return tuple(out)

        n_pin = len(self.rv_pin_ids)
        return {
            "picked": self._dev("src", a.src)[rows, sel.long()],
            "cons_used": cons_used,
            "cons_used_reg": cons_used[self._dev("reg_ids", a.reg_ids)],
            "pe": self._pe_program({k: self._ints(v)[None]
                                    for k, v in pe_cfg.items()}),
            "pins_d": self._zeros(n_pin), "pins_v": self._zeros(n_pin),
            "fix_mask": torch.zeros(n, dtype=torch.bool, device=self.device),
            "fix_val": self._zeros(n),
            "d": buffers(n + 1, [0]), "v": buffers(n + 2, [0, 1]),
            "r": buffers(n + 1, [1]),
        }

    def _rv_start(self, cyc: State, state: State, ext_in: torch.Tensor,
                  ext_valid: torch.Tensor,
                  sink_ready: Optional[torch.Tensor]) -> None:
        """A cycle's pinned sources and first values: register heads and
        occupancy, the external drive; the backward pass's pinned ready
        (full: registered ``occ < 2``; split: ready where empty, else
        pop-aware through the chain) with the sinks' over it."""
        a = self.arrays
        n = a.num_nodes
        r = len(a.reg_ids)
        occ, slots = state["occ"], state["slots"]
        cyc["pins_d"][:r].copy_(slots[:, 0])
        cyc["pins_d"][r:].copy_(ext_in)
        cyc["pins_v"][:r].copy_(occ > 0)
        cyc["pins_v"][r:].copy_(ext_valid)
        pin_ids = self._dev("rv_pin_ids", self.rv_pin_ids)
        d0, v0, r0 = cyc["d"][0], cyc["v"][0], cyc["r"][0]
        d0[:n].zero_()
        d0.index_copy_(0, pin_ids, cyc["pins_d"])
        v0[:n].zero_()
        v0.index_copy_(0, pin_ids, cyc["pins_v"])
        r0[:n].fill_(1)

        mask, val = cyc["fix_mask"], cyc["fix_val"]
        val.fill_(1)
        mask.zero_()
        if r:
            reg_ids = self._dev("reg_ids", a.reg_ids)
            if self.fifo_mode == "full":
                mask.index_fill_(0, reg_ids, True)
                val.index_copy_(0, reg_ids, (occ < 2).to(torch.int32))
            else:
                mask.index_copy_(0, reg_ids, occ < 1)
        if self.num_io:
            io_out = self._dev("io_out", self.io_out_nodes)
            mask.index_fill_(0, io_out, True)
            if sink_ready is not None:
                val.index_copy_(0, io_out, sink_ready)

    def _forward_sweep(self, cyc: State, cur: int, nxt: int) -> None:
        """One forward sweep of (data, valid) from buffers ``cur`` into
        ``nxt``: every driven node's selected source, undriven nodes held,
        the sources re-pinned, the PE cores' data and valid evaluated."""
        n = self.arrays.num_nodes
        keep = self._dev("keep", ~self.arrays.is_driven, torch.bool)
        pin_ids = self._dev("rv_pin_ids", self.rv_pin_ids)
        for name in ("d", "v"):
            c, x = cyc[name][cur], cyc[name][nxt]
            torch.index_select(c, 0, cyc["picked"], out=x[:n])
            torch.where(keep, c[:n], x[:n], out=x[:n])
            x.index_copy_(0, pin_ids, cyc["pins_" + name])
        self._eval_pes(cyc["d"][nxt][None], cyc["pe"])
        self._eval_pe_valid(cyc["v"][nxt])

    def _eval_pe_valid(self, valid: torch.Tensor) -> None:
        """PE fires when its inputs a and b are valid (an absent input
        reads 1): both outputs' valid, in place on the (N+2,) buffer."""
        if self.num_pe == 0:
            return
        ins = self._dev("pe_valid_in", self.pe_valid_in)
        fire = torch.minimum(valid[ins[:, 0]], valid[ins[:, 1]])
        out_ids = self._dev("pe_out", self.pe_out)
        for col in range(self.pe_out.shape[1]):
            valid.index_copy_(0, out_ids[:, col], fire)

    def _backward_sweep(self, cyc: State, cur: int, nxt: int) -> None:
        """One backward sweep of ready from ``cur`` into ``nxt`` with the
        one-hot join (Fig. 5): each node's ready is the AND (min) over its
        used consumers' ready, then the pinned nodes' (registers, sinks).
        In split mode a register that holds a token reads its pop, which
        is that same join: the chain is the sweep itself."""
        n = self.arrays.num_nodes
        c, x = cyc["r"][cur], cyc["r"][nxt]
        joined = c[cyc["cons_used"]].amin(dim=1)
        torch.where(cyc["fix_mask"], cyc["fix_val"], joined, out=x[:n])

    def _reg_pop(self, cyc: State, ready: torch.Tensor) -> torch.Tensor:
        """Whether each register's head is consumed this cycle: its
        consumer mux selects it AND that consumer is ready."""
        return ready[cyc["cons_used_reg"]].amin(dim=1)

    def _rv_clock(self, cyc: State, state: State, depth: int
                  ) -> Tuple[State, Outputs]:
        """From a cycle's settled buffers: the FIFO pop (shift down), push
        and occupancy, and the io observations (sink data and valid,
        source ready)."""
        a = self.arrays
        n = a.num_nodes
        k = depth % 2
        data, valid, ready = cyc["d"][k], cyc["v"][k], cyc["r"][k]
        new_state = dict(state)
        if len(a.reg_ids):
            occ, slots = state["occ"], state["slots"]
            pop = self._reg_pop(cyc, ready) * (occ > 0)
            reg_src = self._dev("reg_src", a.reg_src)
            in_data, in_valid = data[reg_src], valid[reg_src]
            push = in_valid * ready[self._dev("reg_ids", a.reg_ids)]
            occ_after_pop = occ - pop
            # shift-down FIFO: on pop, slot1 -> slot0
            shifted = torch.stack(
                [slots[:, 1], torch.zeros_like(slots[:, 1])], dim=1)
            slots = torch.where((pop > 0)[:, None], shifted, slots)
            write_idx = torch.clamp(occ_after_pop, 0, 1).long()
            do_push = (push > 0) & (occ_after_pop < self.fifo_depth)
            written = slots.clone()
            written[torch.arange(len(a.reg_ids), device=self.device),
                    write_idx] = in_data
            new_state["slots"] = torch.where(do_push[:, None], written, slots)
            new_state["occ"] = occ_after_pop + do_push.to(torch.int32)
        if self.num_io:
            io_out = self._dev("io_out", self.io_out_nodes)
            io_in = self._dev("io_in", self.io_in_nodes)
            outs = (data[:n][io_out], valid[:n][io_out], ready[:n][io_in])
        else:
            outs = (self._zeros(0),) * 3
        return new_state, outs

    # ------------------------------------------------------------- the sweeps
    def _rv_sweeps(self, cyc: State, depth: int) -> None:
        """A cycle's ``depth`` forward and ``depth`` backward sweeps,
        eagerly."""
        for k in range(depth):
            self._forward_sweep(cyc, k % 2, (k + 1) % 2)
        for k in range(depth):
            self._backward_sweep(cyc, k % 2, (k + 1) % 2)

    def _rv_path(self, depth: int, cycles: int) -> str:
        """How a run's sweeps go: ``"kernel"`` (one ``rv_sweeps`` launch
        a cycle) on the card with ``use_kernels`` where the plan
        (``rv_plan``) gives the fabric a cluster, ``"eager"`` elsewhere
        and for an empty run."""
        if not (self.device.type == "cuda" and self.use_kernels
                and depth > 0 and cycles > 0):
            return "eager"
        cluster = rv_plan(self._dev("src", self.arrays.src, torch.int32),
                          self._dev("pe_out", self.pe_out))[0]
        return "kernel" if cluster else "eager"

    def _rv_tables(self, cyc: State) -> State:
        """The ``rv_sweeps`` kernel's tables for the run's configuration
        (``rv_tables``)."""
        a, pe = self.arrays, cyc["pe"]
        return rv_tables(
            self._dev("src", a.src, torch.int32), cyc["picked"],
            self._dev("keep", ~a.is_driven, torch.bool),
            self._dev("rv_pin_ids", self.rv_pin_ids),
            self._dev("pe_in_raw", self.pe_in), self._dev("pe_out",
                                                          self.pe_out),
            pe["op"][0, 0], pe["const"][0],
            pe["imm_mask"][0] if "imm_mask" in pe else None,
            pe["imm_val"][0] if "imm_mask" in pe else None,
            cyc["cons_used"])

    def _rv_run(self, config, pe_cfg: Optional[State], depth: int,
                cycles: int, drive: Callable[[int], Tuple[torch.Tensor, ...]],
                observe: Callable[[int, Outputs], None]) -> None:
        """``cycles`` cycles from ``init_state``: ``drive(t)`` gives the
        cycle's (ext_in, ext_valid, sink_ready), ``observe(t, outs)`` takes
        its outputs. The sweeps go as ``_rv_path`` says: one kernel launch
        a cycle from tables resolved once a run (``rv.tables``), or
        eagerly. A cycle's spans part its sweeps (``rv.sweeps``) from its
        eager drive and FIFO update (``rv.start``, ``rv.clock``)."""
        cyc = self._rv_cycle(config, pe_cfg)
        state = self.init_state()
        path = self._rv_path(depth, cycles)
        if path == "kernel":
            with span("rv.tables"):
                tables = self._rv_tables(cyc)
        for t in range(cycles):
            with span("rv.start"):
                self._rv_start(cyc, state, *drive(t))
            with span("rv.sweeps"):
                if path == "kernel":
                    rv_sweeps(tables, cyc["d"], cyc["v"], cyc["r"],
                              cyc["pins_d"], cyc["pins_v"], cyc["fix_mask"],
                              cyc["fix_val"], depth, WORD)
                    self.kernel_cycles += 1
                else:
                    self._rv_sweeps(cyc, depth)
            with span("rv.clock"):
                state, outs = self._rv_clock(cyc, state, depth)
                observe(t, outs)
        self.last_state = state

    # -------------------------------------------------------------- the cycle
    def step(self, state: State, ext_in, ext_valid, config,
             pe_cfg: Optional[State] = None, ext_sink_ready=None,
             depth: int = 24) -> Tuple[State, Outputs]:
        """One NoC cycle, sweep by sweep. Returns (state', (io_data,
        io_valid, io_in_ready)).

        io_in_ready is the backpressure the fabric presents to external
        producers (at io_out ports)."""
        cyc = self._rv_cycle(config, pe_cfg)
        state = {k: self._ints(v) for k, v in state.items()}
        sink = None if ext_sink_ready is None else self._ints(ext_sink_ready)
        self._rv_start(cyc, state, self._ints(ext_in),
                       self._ints(ext_valid), sink)
        self._rv_sweeps(cyc, depth)
        return self._rv_clock(cyc, state, depth)

    def run_stream(self, config, ext_data, ext_valid, ext_sink_ready=None,
                   pe_cfg: Optional[State] = None,
                   depth: int = 24) -> Outputs:
        """Run T cycles of the NoC. ext_data/ext_valid: (T, num_io).
        ext_sink_ready: (T, num_io) backpressure from external consumers.
        Returns (io_data, io_valid, io_in_ready), each (T, num_io)."""
        data, valid = self._ints(ext_data), self._ints(ext_valid)
        sink = (torch.ones_like(valid) if ext_sink_ready is None
                else self._ints(ext_sink_ready))
        cycles = data.shape[0]
        outs = tuple(self._zeros(cycles, self.num_io) for _ in range(3))

        def observe(t: int, got: Outputs) -> None:
            for o, g in zip(outs, got):
                o[t].copy_(g)

        self._rv_run(config, pe_cfg, depth, cycles,
                     lambda t: (data[t], valid[t], sink[t]), observe)
        return outs

    def run_with_sources(self, config, streams, stream_lens, sink_ready,
                         pe_cfg: Optional[State] = None,
                         depth: int = 24) -> Outputs:
        """Run with handshake-respecting sources: each IO presents
        ``streams[ptr, io]`` and only advances its pointer when the fabric
        accepts (valid & ready). This is the latency-insensitive testbench
        the hybrid interconnect is designed for.

        streams: (T, num_io) data; stream_lens: (num_io,) items per source;
        sink_ready: (T, num_io) external consumer backpressure.
        Returns (io_data, io_valid, accepted_mask) each (T, num_io)."""
        streams, lens = self._ints(streams), self._ints(stream_lens)
        sink = self._ints(sink_ready)
        t_max = streams.shape[0]
        cycles = sink.shape[0]
        io = torch.arange(self.num_io, device=self.device)
        ptr = self._zeros(self.num_io)
        cur = {}
        outs = tuple(self._zeros(cycles, self.num_io) for _ in range(3))

        def drive(t: int) -> Tuple[torch.Tensor, ...]:
            cur["v"] = (ptr < lens).to(torch.int32)
            return (streams[torch.clamp(ptr, 0, t_max - 1).long(), io],
                    cur["v"], sink[t])

        def observe(t: int, got: Outputs) -> None:
            od, ov, orr = got
            ptr.add_(cur["v"] * orr)
            outs[0][t].copy_(od)
            outs[1][t].copy_(ov)
            outs[2][t].copy_(ov * sink[t])

        self._rv_run(config, pe_cfg, depth, cycles, drive, observe)
        return outs


def east_route(ic: Interconnect, y: int = 1, track: int = 0,
               bit_width: int = 16) -> List[Tuple[Node, Node]]:
    """The routed IR edges of a stream straight east across the fabric at
    row ``y`` on ``track`` of the ``bit_width`` graph: from the west IO
    tile's ``io_out`` through every column's SB output, its register (a
    FIFO stage on a ready-valid fabric) and register mux, into the east
    IO tile's ``io_in`` — one register a hop, W - 1 in all on a fabric W
    tiles wide (IO ring included)."""
    g = ic.graph(bit_width)
    edges = []
    port = g.get_port(0, y, "io_out")
    cur = g.get_sb(0, y, Side.EAST, track, IO.SB_OUT)
    edges.append((port, cur))
    w = ic.dims()[0]
    for x in range(1, w):
        rmux = [n for n in cur.fan_out if n.kind == NodeKind.REG_MUX][0]
        reg = [n for n in cur.fan_out if n.kind == NodeKind.REGISTER][0]
        edges += [(cur, reg), (reg, rmux)]
        sb_in = rmux.fan_out[0]
        edges.append((rmux, sb_in))
        if x < w - 1:
            nxt = g.get_sb(x, y, Side.EAST, track, IO.SB_OUT)
            edges.append((sb_in, nxt))
            cur = nxt
        else:
            edges.append((sb_in, g.get_port(x, y, "io_in")))
    return edges


def compile_ready_valid(ic: Interconnect, fifo_mode: str = "split",
                        device: DeviceLike = None,
                        use_kernels: bool = False) -> RVFabric:
    """Ready-valid backend entry point (the hybrid interconnect, §3.3)."""
    return RVFabric(ic, fifo_mode=fifo_mode, device=device,
                    use_kernels=use_kernels)

"""Pass-based interconnect compiler (the Canal eDSL reworked as IR passes).

The paper's central claim is that a graph-based IR makes interconnect
generation *composable*: the hybrid ready-valid interconnect is produced
by transforming the static IR, not by a second generator. This module
realizes that as a linear pipeline of named, individually-testable passes
over :mod:`repro_torch.core.graph`:

    materialize_tiles        tiles + bare switch boxes, one graph per layer
    apply_sb_topology        internal SB edges (disjoint/wilton/imran)
    insert_pipeline_registers  inter-tile wires, REG/RMUX at reg_density
    connect_core_ports       CB-in / SB-out core connections (Fc, sides)
    readyvalid_transform     (spec.ready_valid only) tag the IR for the
                             hybrid ready-valid lowering
    prune_dead_muxes         drop fully isolated nodes
    freeze                   attach spec + params; the IR is now a design

Each pass is a plain function ``(PassContext) -> None`` mutating
``ctx.ic``; :class:`PassManager` sequences them and records a per-pass
log. ``PassManager().compile(spec)`` is the single front door (also
exported as ``canal_torch.compile``); the legacy
``edsl.create_uniform_interconnect`` is a deprecation shim over the same
pipeline, so both produce isomorphic IR by construction.

Determinism contract: passes iterate tiles row-major and sides in
``ALL_SIDES`` order, and every pass appends to disjoint fan-in lists, so
compiling the same spec twice yields identical connectivity — node order,
mux input order (config-bit semantics) and edge delays included.
``ir_digest`` condenses that into one hash for golden tests.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import span

from .graph import (IO, Interconnect, InterconnectGraph, NodeKind,
                    RegisterMuxNode, RegisterNode, SBConnection, Side,
                    SwitchBox, SwitchBoxNode, Tile)
from .spec import InterconnectSpec, SwitchBoxType
from .tiles import Core, default_core_assigner

ALL_SIDES: Tuple[Side, ...] = (Side.NORTH, Side.SOUTH, Side.EAST, Side.WEST)

CoreFn = Callable[[int, int, int, int], Optional[Core]]


@dataclass
class PassContext:
    """Mutable state threaded through the pipeline: the spec being
    compiled, the core assigner, the IR under construction, and a
    per-pass log (inspect it to see e.g. what ``prune_dead_muxes``
    removed)."""

    spec: InterconnectSpec
    core_fn: CoreFn
    ic: Optional[Interconnect] = None
    log: List[Dict] = field(default_factory=list)
    #: filled by ``PassManager.run(..., analyze_per_pass=True)``: the
    #: final AnalysisReport with each diagnostic's ``pass_name`` set to
    #: the first pass after which the finding appears (and persists)
    analysis_report: Optional[object] = None

    def graphs(self) -> Dict[int, InterconnectGraph]:
        assert self.ic is not None, "materialize_tiles has not run"
        return self.ic.graphs


# ---------------------------------------------------------------------------
# Switch-box topologies (§4.2.1, Fig. 9) — imported lazily from edsl to keep
# the historical home of the connection generators (and avoid an import
# cycle: edsl's deprecation shim calls back into this module).
# ---------------------------------------------------------------------------

def _topology_fn(sb_type: SwitchBoxType) -> Callable[[int],
                                                     List[SBConnection]]:
    from .edsl import SB_TOPOLOGIES
    return SB_TOPOLOGIES[sb_type]


# ---------------------------------------------------------------------------
# Passes
# ---------------------------------------------------------------------------

def materialize_tiles(ctx: PassContext) -> None:
    """One :class:`InterconnectGraph` per routing layer, populated with
    tiles, cores and *bare* switch boxes (no edges yet)."""
    spec = ctx.spec
    graphs: Dict[int, InterconnectGraph] = {}
    for bit_width, n_tracks in spec.layers().items():
        g = InterconnectGraph(bit_width)
        for y in range(spec.height):
            for x in range(spec.width):
                sb = SwitchBox(x, y, n_tracks, bit_width, [],
                               mux_delay=spec.mux_delay)
                core = ctx.core_fn(x, y, spec.width, spec.height)
                g.add_tile(Tile(x, y, sb, core))
        graphs[bit_width] = g
    ctx.ic = Interconnect(graphs)
    ctx.log.append({"pass": "materialize_tiles",
                    "layers": len(graphs),
                    "tiles": spec.width * spec.height})


def apply_sb_topology(ctx: PassContext) -> None:
    """Wire each switch box's internal topology (track permutations)."""
    topo = _topology_fn(ctx.spec.sb_type)
    conns_cache: Dict[int, List[SBConnection]] = {}
    n_edges = 0
    for g in ctx.graphs().values():
        for tile in g.tiles.values():
            nt = tile.switchbox.num_tracks
            conns = conns_cache.get(nt)
            if conns is None:
                conns = conns_cache.setdefault(nt, topo(nt))
            tile.switchbox.add_internal_connections(conns)
            n_edges += len(conns)
    ctx.log.append({"pass": "apply_sb_topology",
                    "topology": ctx.spec.sb_type.value,
                    "edges": n_edges})


def _reg_pattern(spec: InterconnectSpec, x: int, y: int, track: int) -> bool:
    """Deterministic register placement at the requested density."""
    if spec.reg_density <= 0.0:
        return False
    if spec.reg_density >= 1.0:
        return True
    period = max(1, round(1.0 / spec.reg_density))
    return (x + y + track) % period == 0


def _insert_register(g: InterconnectGraph, src: SwitchBoxNode,
                     dst: SwitchBoxNode, side: Side, track: int,
                     spec: InterconnectSpec) -> None:
    """src -> REG -> RMUX -> dst, with src -> RMUX bypass (canal pattern)."""
    name = f"{side.name}_{track}"
    reg = RegisterNode(name, src.x, src.y, track, src.width, delay=0.0)
    rmux = RegisterMuxNode(name, src.x, src.y, track, src.width,
                           delay=spec.mux_delay)
    src.add_edge(reg)
    reg.add_edge(rmux)
    src.add_edge(rmux)                      # bypass path
    rmux.add_edge(dst, delay=spec.wire_delay)
    g.add_register(reg)
    g.add_reg_mux(rmux)


def insert_pipeline_registers(ctx: PassContext) -> None:
    """Inter-tile wiring: each SB_OUT drives the facing SB_IN of the
    neighbouring tile — through a REG/RMUX pipeline stage on tracks
    selected by the deterministic ``reg_density`` pattern, as a plain
    wire otherwise."""
    spec = ctx.spec
    n_regs = 0
    for g in ctx.graphs().values():
        for (x, y), tile in g.tiles.items():
            for side in ALL_SIDES:
                dx, dy = side.delta()
                nbr = g.get_tile(x + dx, y + dy)
                if nbr is None:
                    continue
                for t in range(tile.switchbox.num_tracks):
                    src = tile.switchbox.get_sb(side, t, IO.SB_OUT)
                    dst = nbr.switchbox.get_sb(side.opposite(), t, IO.SB_IN)
                    if _reg_pattern(spec, x, y, t):
                        _insert_register(g, src, dst, side, t, spec)
                        n_regs += 1
                    else:
                        src.add_edge(dst, delay=spec.wire_delay)
    ctx.log.append({"pass": "insert_pipeline_registers",
                    "registers": n_regs})


def connect_core_ports(ctx: PassContext) -> None:
    """Core <-> interconnect: CB in (SB_IN -> port) and SB out
    (port -> SB_OUT), honouring the Fig. 12 side reduction and the track
    population fraction Fc (staggered per port, VPR-style)."""
    spec = ctx.spec
    cb_sides = spec.cb_connection_sides()
    sb_sides = spec.sb_connection_sides()
    cb_stride = max(1, round(1.0 / max(spec.cb_track_fc, 1e-6)))
    sb_stride = max(1, round(1.0 / max(spec.sb_track_fc, 1e-6)))
    n_edges = 0
    for g in ctx.graphs().values():
        bit_width = g.width
        for tile in g.tiles.values():
            if tile.core is None:
                continue
            n_tracks = tile.switchbox.num_tracks
            for pi, p in enumerate(tile.core.inputs()):
                if p.width != bit_width:
                    continue
                port = tile.get_port(p.name)
                for side in cb_sides:
                    for t in range(n_tracks):
                        if (t + pi) % cb_stride != 0:
                            continue
                        sb_in = tile.switchbox.get_sb(side, t, IO.SB_IN)
                        sb_in.add_edge(port, delay=spec.cb_delay)
                        n_edges += 1
            for pi, p in enumerate(tile.core.outputs()):
                if p.width != bit_width:
                    continue
                port = tile.get_port(p.name)
                for side in sb_sides:
                    for t in range(n_tracks):
                        if (t + pi) % sb_stride != 0:
                            continue
                        sb_out = tile.switchbox.get_sb(side, t, IO.SB_OUT)
                        port.add_edge(sb_out)
                        n_edges += 1
    ctx.log.append({"pass": "connect_core_ports", "edges": n_edges})


def readyvalid_transform(ctx: PassContext) -> None:
    """Hybrid ready-valid interconnect as an IR *transform* (paper §3.3):
    the static IR is annotated — every pipeline register becomes a FIFO
    stage (full depth-2 or split single-slot chain per the spec) and the
    top-level params request the ready-valid lowering. The structural
    graph is untouched: valid reuses the data mux network and ready is
    derived from the same one-hot selects at lowering time
    (:class:`repro_torch.fabric.RVFabric`)."""
    spec = ctx.spec
    if spec.fifo_depth != 2:
        # the architecture fixes the effective depth at 2 (a depth-2 FIFO
        # in full mode, two chained single-slot stages in split mode);
        # silently compiling a different request would make the spec
        # field decorative and split caches for identical hardware
        raise ValueError(
            f"ready-valid lowering implements depth-2 FIFOs only "
            f"(full: one depth-2 FIFO; split: chained 1+1), got "
            f"fifo_depth={spec.fifo_depth}")
    mode = "split" if spec.split_fifo else "full"
    n_fifos = 0
    for g in ctx.graphs().values():
        for reg in g.registers:
            reg.attributes["rv_fifo"] = mode
            reg.attributes["fifo_depth"] = spec.fifo_depth
            n_fifos += 1
    assert ctx.ic is not None
    ctx.ic.params["rv_fifo_mode"] = mode
    ctx.log.append({"pass": "readyvalid_transform", "mode": mode,
                    "fifos": n_fifos})


def prune_dead_muxes(ctx: PassContext) -> None:
    """Drop nodes no configuration can ever observe, iterated to a
    fixpoint: a non-port node with no fan-out drives nothing, so it (and
    its incoming edges) can go — which may leave an upstream mux
    observer-free in turn, so the pass repeats until a round removes
    nothing. Pruning only ever detaches *incoming* edges (see
    ``InterconnectGraph.prune``), so surviving mux fan-in order — and
    with it config-bit semantics — is untouched. Two node classes are
    interface, not waste, and always kept: core ports, and switch-box
    nodes on an array boundary (their missing on-array consumer is the
    chip pin). On the stock uniform topologies this pass is a no-op
    (every generated node is wired), which is exactly what keeps legacy
    sweep results bit-identical; the ``dead-mux`` analysis rule is the
    convergence oracle."""
    from .analysis.framework import AnalysisContext
    removed = 0
    rounds = 0
    for g in ctx.graphs().values():
        while True:
            # boundary nodes are only exempt while *connected*: a fully
            # isolated boundary node is no pin, just leftover hardware
            dead = [n for n in g.nodes()
                    if n.kind != NodeKind.PORT
                    and not n.fan_out
                    and (not n.fan_in
                         or not AnalysisContext.faces_off_array(g, n))]
            if not dead:
                break
            g.prune(dead)
            removed += len(dead)
            rounds += 1
    ctx.log.append({"pass": "prune_dead_muxes", "removed": removed,
                    "rounds": rounds})


def freeze(ctx: PassContext) -> None:
    """Finalize: attach the spec and flat params to the IR (consumed by
    PnR, area and the DSE record stream) plus the spec digest, the
    content address of this design point."""
    spec = ctx.spec
    ic = ctx.ic
    assert ic is not None
    ic.params.update(dict(
        width=spec.width, height=spec.height, sb_type=spec.sb_type.value,
        num_tracks=spec.num_tracks, track_width=spec.track_width,
        reg_density=spec.reg_density, cb_sides=spec.cb_sides,
        sb_sides=spec.sb_sides, ready_valid=spec.ready_valid,
        fifo_depth=spec.fifo_depth, split_fifo=spec.split_fifo,
        wire_delay=spec.wire_delay, mux_delay=spec.mux_delay,
    ))
    ic.params["spec_digest"] = spec.digest()
    ic.spec = spec  # type: ignore[attr-defined]
    ctx.log.append({"pass": "freeze", "spec_digest": spec.digest(),
                    "nodes": ic.num_nodes()})


def _default_core_fn(spec: InterconnectSpec) -> CoreFn:
    """The one place the spec's core-related fields turn into a core
    assigner — shared by PassManager.run/.compile and (through them) the
    legacy edsl shim, so the three entry points cannot diverge."""
    return default_core_assigner(
        mem_columns=spec.mem_columns, io_ring=spec.io_ring,
        pe_inputs=spec.pe_inputs, pe_outputs=spec.pe_outputs,
        width=spec.track_width, pred=has_bit_layer(spec))


def has_bit_layer(spec: InterconnectSpec) -> bool:
    """Whether ``spec`` routes a 1-bit layer beside its data tracks: its
    PEs and IOs then have the 1-bit predicate ports (``core/tiles.py``)."""
    return spec.track_width != 1 and 1 in spec.layers()


# ---------------------------------------------------------------------------
# Pass manager
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IRPass:
    """A named pipeline stage; ``when`` gates optional passes on the
    spec (e.g. the ready-valid transform)."""

    name: str
    run: Callable[[PassContext], None]
    when: Callable[[InterconnectSpec], bool] = lambda spec: True


DEFAULT_PASSES: Tuple[IRPass, ...] = (
    IRPass("materialize_tiles", materialize_tiles),
    IRPass("apply_sb_topology", apply_sb_topology),
    IRPass("insert_pipeline_registers", insert_pipeline_registers),
    IRPass("connect_core_ports", connect_core_ports),
    IRPass("readyvalid_transform", readyvalid_transform,
           when=lambda spec: spec.ready_valid),
    IRPass("prune_dead_muxes", prune_dead_muxes),
    IRPass("freeze", freeze),
)


class PassManager:
    """Sequences IR passes over a spec. ``run`` yields the raw
    :class:`Interconnect`; ``compile`` wraps it in a
    :class:`repro_torch.core.compile.CompiledFabric` handle (PnR, emulation,
    area, bitstream)."""

    def __init__(self, passes: Sequence[IRPass] = DEFAULT_PASSES):
        self.passes: Tuple[IRPass, ...] = tuple(passes)
        names = [p.name for p in self.passes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pass names in {names}")

    def pipeline_for(self, spec: InterconnectSpec) -> List[str]:
        """The pass names that would run for ``spec`` (gates applied)."""
        return [p.name for p in self.passes if p.when(spec)]

    def run(self, spec: InterconnectSpec,
            core_fn: Optional[CoreFn] = None,
            ctx: Optional[PassContext] = None,
            analyze_per_pass: bool = False) -> Interconnect:
        """Compile ``spec`` into the IR by running every (enabled) pass
        in order. ``core_fn`` is the non-serializable escape hatch for
        custom tile contents; ``ctx`` lets tests inject a pre-seeded
        context (e.g. to run a partial pipeline).

        ``analyze_per_pass`` re-runs the static analyzer after every
        pass and attributes each surviving diagnostic to the first pass
        that introduced it (``ctx.analysis_report``) — the "which pass
        broke my fabric" debugging mode. Transient findings that a later
        pass legitimately resolves (a half-built pipeline is full of
        them) are discarded: only findings still present in the final IR
        are reported."""
        if core_fn is None:
            core_fn = _default_core_fn(spec)
        if ctx is None:
            ctx = PassContext(spec=spec, core_fn=core_fn)
        snapshots: List[Tuple[str, object]] = []
        with span("ir.passes"):
            for p in self.passes:
                if p.when(spec):
                    p.run(ctx)
                    if analyze_per_pass and ctx.ic is not None:
                        from .analysis import analyze as _analyze
                        snapshots.append(
                            (p.name, _analyze(ctx.ic, spec=spec)))
        if analyze_per_pass:
            ctx.analysis_report = _attribute_to_passes(snapshots)
        assert ctx.ic is not None
        return ctx.ic

    def compile(self, spec: InterconnectSpec,
                core_fn: Optional[CoreFn] = None,
                device=None,
                use_kernels: bool = False,
                analyze: str = "warn",
                analyze_per_pass: bool = False):
        """The front door: spec -> CompiledFabric.

        ``analyze`` gates the static analyzer (``repro_torch.core.analysis``)
        over the compiled IR: ``"warn"`` (default) attaches the report
        as ``CompiledFabric.diagnostics``; ``"error"`` additionally
        raises :class:`AnalysisError` when any finding is
        error-severity; ``"off"`` skips analysis. ``analyze_per_pass``
        attributes each finding to the pass that introduced it (slower:
        the analyzer runs once per pass). The fabric's backends run on
        ``device`` (``None``: the CUDA card, checked before compiling)."""
        if analyze not in ("off", "warn", "error"):
            raise ValueError(
                f"analyze={analyze!r}: use 'error', 'warn' or 'off'")
        from repro_torch.device import resolve_device
        from .compile import CompiledFabric
        device = resolve_device(device)
        ctx = PassContext(spec=spec,
                          core_fn=core_fn or _default_core_fn(spec))
        ic = self.run(spec, core_fn=ctx.core_fn, ctx=ctx,
                      analyze_per_pass=(analyze_per_pass
                                        and analyze != "off"))
        report = None
        if analyze != "off":
            if ctx.analysis_report is not None:
                report = ctx.analysis_report
            else:
                from .analysis import analyze as _analyze
                report = _analyze(ic, spec=spec)
            if analyze == "error":
                report.raise_if("error")
        return CompiledFabric(spec, ic, pass_log=ctx.log,
                              device=device, use_kernels=use_kernels,
                              cacheable=core_fn is None,
                              diagnostics=report)


def _attribute_to_passes(snapshots: Sequence[Tuple[str, object]]):
    """Blame each *final* diagnostic on the pass that introduced it.

    ``snapshots`` is ``[(pass_name, AnalysisReport), ...]`` in pipeline
    order. A finding is matched across snapshots by ``Diagnostic.key()``
    (rule + location — messages may carry run-varying counts). The
    attributed pass is the first pass of the *final contiguous run* of
    snapshots containing the key: if a finding appeared, was fixed by a
    later pass, then reappeared, the reappearance is what the user needs
    to see. Returns the final report with ``pass_name`` filled in."""
    if not snapshots:
        return None
    final_name, final_report = snapshots[-1]
    key_sets = [{d.key() for d in rep} for _, rep in snapshots]
    attributed = []
    for d in final_report:
        first = len(snapshots) - 1
        while first > 0 and d.key() in key_sets[first - 1]:
            first -= 1
        attributed.append(d.with_pass(snapshots[first][0]))
    final_report.diagnostics = attributed
    return final_report


def ir_digest(ic: Interconnect) -> str:
    """Content hash of the *compiled IR*: sha256 over the sorted
    structural connectivity (node keys + ordered fan-in keys). Two
    interconnects with equal digests are isomorphic down to mux input
    order — the quantity the golden fixtures pin against silent drift."""
    h = hashlib.sha256()
    conn = ic.connectivity()
    for key in sorted(conn, key=repr):
        h.update(repr((key, conn[key])).encode())
    return h.hexdigest()

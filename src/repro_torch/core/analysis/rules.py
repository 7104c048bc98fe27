"""Built-in analysis rules over the interconnect IR.

Each rule is a registered :class:`AnalysisPass` (see ``framework``); ids
are stable and kebab-case — they are the contract CI configs, severity
policies and the mutation tests key on:

========================  =====================================================
rule id                   what it rejects
========================  =====================================================
``combinational-loop``    hardwired register-free cycle: oscillates in
                          silicon under every possible configuration
``dead-mux``              node whose output can never reach an observer
                          (core input / boundary output) — also the
                          ``prune_dead_muxes`` convergence cross-check
``unreachable-node``      node no source (core output / boundary input)
                          can ever drive
``dangling-port``         core port with no interconnect attachment, or a
                          port width with no routing layer at all
``fanin-overflow``        mux fan-in (or per-tile config population, or
                          tile coordinates) the bitstream encoding cannot
                          address
``sb-topology-conformance``  switch-box internal edges deviate from the
                          declared Wilton/Disjoint/Imran pattern
``rv-handshake``          ready-valid design with a handshake dependency
                          cycle not broken by a FIFO stage, or a pipeline
                          register the RV transform never FIFO-tagged
``static-routability``    supply-vs-demand bounds a router can never beat:
                          a core tile whose CB network delivers fewer
                          distinct signals than the core has input ports,
                          or an array bisection with no (or too little)
                          crossing capacity
========================  =====================================================

Severity policy: structural impossibilities (loops, dangling interface,
encoding overflow, topology deviation, handshake deadlock, zero bisection
capacity) are errors — PnR or lowering on such an IR wastes minutes to
discover what these rules prove in milliseconds. Waste and tight-capacity
findings (dead/unreachable nodes, sub-demand supply) are warnings: the
fabric still works for some workloads.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from ..graph import (IO, InterconnectGraph, Node, NodeKind, SwitchBoxNode)
from .diagnostics import Diagnostic, Severity
from .framework import AnalysisContext, register_rule


def _diag(rule: str, severity: Severity, message: str,
          g: Optional[InterconnectGraph] = None,
          node: Optional[Node] = None, tile: Optional[Tuple[int, int]] = None,
          hint: Optional[str] = None) -> Diagnostic:
    if node is not None and tile is None:
        tile = (node.x, node.y)
    return Diagnostic(rule=rule, severity=severity, message=message,
                      width=g.width if g is not None else None,
                      tile=tile,
                      node=repr(node) if node is not None else None,
                      hint=hint)


def _sorted_nodes(nodes: Iterable[Node]) -> List[Node]:
    """Deterministic report order, independent of uid allocation."""
    return sorted(nodes, key=lambda n: repr(n))


# ---------------------------------------------------------------------------
# Cycle analyses (combinational-loop, rv-handshake)
# ---------------------------------------------------------------------------

def _sccs(nodes: List[Node],
          follow: "Callable[[Node, Node], bool]") -> Iterator[List[Node]]:
    """Cyclic strongly-connected components of the node graph restricted
    to edges where ``follow(src, dst)`` holds. Iterative Tarjan — IR
    graphs run to 10^5 nodes, recursion would blow the stack. Yields only
    SCCs that actually contain a cycle (size > 1, or a self-loop)."""
    index: Dict[Node, int] = {}
    low: Dict[Node, int] = {}
    on_stack: Set[Node] = set()
    stack: List[Node] = []
    counter = 0
    for root in nodes:
        if root in index:
            continue
        work: List[Tuple[Node, int]] = [(root, 0)]
        while work:
            n, ei = work[-1]
            if ei == 0:
                index[n] = low[n] = counter
                counter += 1
                stack.append(n)
                on_stack.add(n)
            advanced = False
            while ei < len(n.fan_out):
                m = n.fan_out[ei]
                ei += 1
                if not follow(n, m):
                    continue
                if m not in index:
                    work[-1] = (n, ei)
                    work.append((m, 0))
                    advanced = True
                    break
                if m in on_stack:
                    low[n] = min(low[n], index[m])
            if advanced:
                continue
            work.pop()
            if low[n] == index[n]:
                scc: List[Node] = []
                while True:
                    m = stack.pop()
                    on_stack.discard(m)
                    scc.append(m)
                    if m is n:
                        break
                if len(scc) > 1 or any(
                        x is n and follow(n, n) for x in n.fan_out):
                    yield scc
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[n])


def _hardwired_combinational(src: Node, dst: Node) -> bool:
    """An edge a configuration cannot sever: its destination is a
    register-free fan-in-1 node, i.e. a plain wire, not a mux. Muxes
    (fan-in > 1) leave loop avoidance to the router; registers end the
    combinational path entirely. Any interconnect mesh is full of
    *configurable* register-free cycles — route east then back west —
    and those are healthy; only a cycle made purely of hardwired edges
    is a structural combinational loop that exists in silicon no matter
    what the bitstream says."""
    return dst.kind != NodeKind.REGISTER and len(dst.fan_in) <= 1


@register_rule(
    "combinational-loop",
    description="hardwired register-free cycle: oscillates in hardware "
                "and never converges in emulation, under every possible "
                "configuration")
def combinational_loop(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    """Registers are sequential boundaries (their fan-in feeds next-state,
    not this cycle's value), and muxes are the router's loop-avoidance
    points — so the statically-illegal shape is a cycle of hardwired
    combinational edges (see :func:`_hardwired_combinational`): no
    configuration and no router decision can break it."""
    for g in ctx.graphs():
        nodes = list(g.nodes())
        for scc in _sccs(nodes, follow=_hardwired_combinational):
            members = _sorted_nodes(scc)
            sample = ", ".join(repr(n) for n in members[:3])
            yield _diag(
                "combinational-loop", Severity.ERROR,
                f"hardwired register-free cycle through {len(members)} "
                f"node(s): {sample}"
                f"{', ...' if len(members) > 3 else ''}",
                g, node=members[0],
                hint="insert a pipeline register on the cycle, or give "
                     "one of its nodes a second (mux) input so the "
                     "router can break it")


def _is_rv(ctx: AnalysisContext) -> bool:
    if ctx.ic.params.get("rv_fifo_mode"):
        return True
    return bool(ctx.spec is not None and ctx.spec.ready_valid)


@register_rule(
    "rv-handshake",
    description="ready-valid handshake dependency cycle with no FIFO "
                "break, or a register the RV transform never tagged",
    when=_is_rv)
def rv_handshake(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    """The hybrid ready-valid interconnect derives ``valid`` forward and
    ``ready`` backward along the same mux network; only a FIFO stage
    (a register tagged ``rv_fifo`` by ``readyvalid_transform``) cuts the
    combinational handshake dependency in both directions. A register
    the transform never tagged lowers as a bare pipeline stage with no
    credit, and a cycle whose registers are all untagged deadlocks: the
    ready chain closes on itself."""
    for g in ctx.graphs():
        nodes = list(g.nodes())
        untagged = [n for n in nodes if n.kind == NodeKind.REGISTER
                    and not n.attributes.get("rv_fifo")]
        for n in _sorted_nodes(untagged):
            yield _diag(
                "rv-handshake", Severity.ERROR,
                "pipeline register is not FIFO-tagged in a ready-valid "
                "design: the handshake dependency through it is never "
                "broken",
                g, node=n,
                hint="run readyvalid_transform (or tag the register's "
                     "rv_fifo attribute)")
        def follow(src: Node, dst: Node) -> bool:
            # a FIFO stage cuts the handshake dependency both ways; a
            # bare (untagged) register does NOT — ready still chains
            # through it combinationally. Mux nodes stay the router's
            # responsibility, as in combinational-loop.
            if dst.kind == NodeKind.REGISTER:
                return not dst.attributes.get("rv_fifo")
            return len(dst.fan_in) <= 1

        for scc in _sccs(nodes, follow=follow):
            members = _sorted_nodes(scc)
            sample = ", ".join(repr(n) for n in members[:3])
            yield _diag(
                "rv-handshake", Severity.ERROR,
                f"cyclic ready-valid handshake dependency through "
                f"{len(members)} node(s) with no FIFO break: {sample}"
                f"{', ...' if len(members) > 3 else ''}",
                g, node=members[0],
                hint="ensure a FIFO stage (rv_fifo register) on every "
                     "feedback path")


# ---------------------------------------------------------------------------
# Reachability analyses (dead-mux, unreachable-node)
# ---------------------------------------------------------------------------

@register_rule(
    "dead-mux",
    description="node whose output can never reach a core input "
                "or boundary output (prune_dead_muxes convergence "
                "cross-check)",
    default_severity=Severity.WARNING)
def dead_mux(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    for g in ctx.graphs():
        live = ctx.reaches_sink(g)
        for n in _sorted_nodes(g.nodes()):
            if n.kind == NodeKind.PORT or n in live:
                continue
            if (ctx.faces_off_array(g, n)
                    and (n.fan_in or n.fan_out)):
                continue  # boundary stubs are the array's external pins
            if not n.fan_in and not n.fan_out:
                yield _diag(
                    "dead-mux", Severity.WARNING,
                    "fully isolated node survived to the final IR — "
                    "prune_dead_muxes did not run or did not converge",
                    g, node=n,
                    hint="run the prune_dead_muxes pass (it prunes "
                         "isolated and observer-free nodes to fixpoint)")
            else:
                yield _diag(
                    "dead-mux", Severity.WARNING,
                    "no path from this node to any core input or boundary "
                    "output: no configuration can make its output "
                    "observable",
                    g, node=n,
                    hint="dead hardware burns area; prune_dead_muxes "
                         "removes such chains to fixpoint")


@register_rule(
    "unreachable-node",
    description="node no core output or boundary input can ever "
                "drive",
    default_severity=Severity.WARNING)
def unreachable_node(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    for g in ctx.graphs():
        fed = ctx.reachable_forward(g)
        dead_live = ctx.reaches_sink(g)
        for n in _sorted_nodes(g.nodes()):
            if n.kind == NodeKind.PORT or n in fed:
                continue
            if ctx.faces_off_array(g, n):
                continue
            if not n.fan_in and not n.fan_out:
                continue  # dead-mux owns fully isolated nodes
            if n not in dead_live:
                continue  # already reported as dead-mux; don't double up
            yield _diag(
                "unreachable-node", Severity.WARNING,
                "no path from any core output or boundary input to "
                "this node: it only ever carries reset values",
                g, node=n,
                hint="check connect_core_ports / apply_sb_topology "
                     "coverage for this tile")


# ---------------------------------------------------------------------------
# Interface analyses (dangling-port)
# ---------------------------------------------------------------------------

@register_rule(
    "dangling-port",
    description="core port with no interconnect attachment, or a port "
                "width with no routing layer")
def dangling_port(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    widths = set(ctx.ic.widths)
    first = True
    for g in ctx.graphs():
        for (x, y) in sorted(g.tiles):
            tile = g.tiles[(x, y)]
            if tile.core is None:
                continue
            for p in tile.core.ports:
                if p.width not in widths:
                    if first:  # every layer materializes every port once
                        yield _diag(
                            "dangling-port", Severity.ERROR,
                            f"core port {p.name!r} is {p.width}b but the "
                            f"interconnect has no {p.width}b routing "
                            f"layer (layers: {sorted(widths)})",
                            g, tile=(x, y),
                            hint="add the layer via "
                                 "InterconnectSpec.extra_layers")
                    continue
                if p.width != g.width:
                    continue  # connected in its own layer, checked there
                node = tile.ports[p.name]
                if p.is_input and not node.fan_in:
                    yield _diag(
                        "dangling-port", Severity.ERROR,
                        f"core input port {p.name!r} has no incoming "
                        "connection-box track: the core can never be fed",
                        g, node=node,
                        hint="raise cb_track_fc / cb_sides (the CB "
                             "stride left this port unpopulated)")
                elif not p.is_input and not node.fan_out:
                    yield _diag(
                        "dangling-port", Severity.ERROR,
                        f"core output port {p.name!r} drives no "
                        "switch-box track: results can never leave the "
                        "core",
                        g, node=node,
                        hint="raise sb_track_fc / sb_sides")
        first = False


# ---------------------------------------------------------------------------
# Encoding analyses (fanin-overflow)
# ---------------------------------------------------------------------------

@register_rule(
    "fanin-overflow",
    description="mux fan-in, per-tile config population or tile "
                "coordinates the bitstream encoding cannot address")
def fanin_overflow(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    """The bitstream word is ``x:8 | y:8 | feature:8 | reg:8`` with the
    select in a ``config_data_width``-bit data field (see
    ``repro_torch.core.bitstream``). Three statically-checkable budgets fall
    out: a mux's select must fit the data field, each tile's per-feature
    configurable-node count must fit the 8-bit reg index, and tile
    coordinates must fit their 8-bit address fields. Overflow only
    surfaces today when ``BitstreamCodec`` raises at encode time — after
    PnR already spent its minutes."""
    max_select = 1 << ctx.ic.config_data_width
    for g in ctx.graphs():
        feat_counts: Dict[Tuple[int, int, str], int] = {}
        for n in _sorted_nodes(g.nodes()):
            fi = len(n.fan_in)
            if fi > max_select:
                yield _diag(
                    "fanin-overflow", Severity.ERROR,
                    f"mux fan-in {fi} needs select values up to {fi - 1} "
                    f"but the config data field is "
                    f"{ctx.ic.config_data_width} bit(s) "
                    f"(max {max_select - 1})",
                    g, node=n,
                    hint="widen config_data_width or depopulate the mux")
            if fi > 1 and n.kind != NodeKind.REGISTER:
                feature = (f"CB_{n.port_name}"
                           if n.kind == NodeKind.PORT else "SB")
                key = (n.x, n.y, feature)
                feat_counts[key] = feat_counts.get(key, 0) + 1
            if not (0 <= n.x < 256 and 0 <= n.y < 256):
                yield _diag(
                    "fanin-overflow", Severity.ERROR,
                    f"tile coordinate ({n.x},{n.y}) exceeds the 8-bit "
                    "bitstream address fields",
                    g, node=n,
                    hint="arrays beyond 256x256 need a wider address "
                         "encoding")
        for (x, y, feature), count in sorted(feat_counts.items()):
            if count > 256:
                yield _diag(
                    "fanin-overflow", Severity.ERROR,
                    f"{count} configurable {feature} muxes in one tile "
                    "exceed the 256-entry per-feature register index",
                    g, tile=(x, y),
                    hint="reduce num_tracks or split the feature space")


# ---------------------------------------------------------------------------
# Topology conformance (sb-topology-conformance)
# ---------------------------------------------------------------------------

def _has_spec(ctx: AnalysisContext) -> bool:
    return ctx.spec is not None


@register_rule(
    "sb-topology-conformance",
    description="switch-box internal edges deviate from the declared "
                "Wilton/Disjoint/Imran pattern",
    when=_has_spec)
def sb_topology_conformance(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    """Recomputes the declared topology's (in, out) pairs per switch box
    and diffs them against the edges actually present — catching both a
    mis-applied pattern and later passes (or hand edits) that severed or
    added internal SB edges. The declared pattern comes from the same
    generator ``apply_sb_topology`` uses, so a legitimate topology change
    updates both sides at once."""
    from ..edsl import SB_TOPOLOGIES
    assert ctx.spec is not None
    topo = SB_TOPOLOGIES[ctx.spec.sb_type]
    expected_cache: Dict[int, Set[Tuple[int, int, int, int]]] = {}
    for g in ctx.graphs():
        for (x, y) in sorted(g.tiles):
            sb = g.tiles[(x, y)].switchbox
            nt = sb.num_tracks
            expected = expected_cache.get(nt)
            if expected is None:
                expected = {(t_from, int(s_from), t_to, int(s_to))
                            for (t_from, s_from, t_to, s_to) in topo(nt)}
                expected_cache[nt] = expected
            actual: Set[Tuple[int, int, int, int]] = set()
            for side in sb.sbs:
                for src in sb.sbs[side][IO.SB_IN]:
                    for dst in src.fan_out:
                        if (isinstance(dst, SwitchBoxNode)
                                and dst.io == IO.SB_OUT
                                and dst.x == x and dst.y == y):
                            actual.add((src.track, int(src.side),
                                        dst.track, int(dst.side)))
            if actual == expected:
                continue
            missing = len(expected - actual)
            extra = len(actual - expected)
            sample = next(iter(sorted(expected - actual)
                               or sorted(actual - expected)))
            yield _diag(
                "sb-topology-conformance", Severity.ERROR,
                f"switch box deviates from the declared "
                f"{ctx.spec.sb_type.value} pattern: {missing} edge(s) "
                f"missing, {extra} extra (e.g. track{sample[0]} "
                f"side{sample[1]} -> track{sample[2]} side{sample[3]})",
                g, tile=(x, y),
                hint="the IR was mutated after apply_sb_topology, or a "
                     "custom pipeline skipped/duplicated the pass")


# ---------------------------------------------------------------------------
# Routability bound (static-routability)
# ---------------------------------------------------------------------------

@register_rule(
    "static-routability",
    description="supply-vs-demand bound a router can never beat: "
                "under-fed core tiles or a starved array bisection",
    default_severity=Severity.WARNING)
def static_routability(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    """Cheap necessary conditions for routing N-port applications,
    checked in milliseconds instead of a PathFinder run:

    * **tile operand supply** — an app net occupies one distinct signal
      into the tile per core input port it feeds; if the CB network
      delivers fewer distinct driving nodes than the core has input
      ports, no placement can ever use all of them (Hall's condition on
      the port-to-track bipartite graph, the cheap half);
    * **bisection supply** — any app communicating across the array's
      middle cut needs at least one crossing wire per direction, and an
      app feeding one max-fan-in core entirely from across the cut needs
      at least that core's input count. Zero capacity with cores on both
      sides is a hard error; sub-demand capacity is a warning."""
    for g in ctx.graphs():
        max_inputs = 0
        for (x, y) in sorted(g.tiles):
            tile = g.tiles[(x, y)]
            if tile.core is None:
                continue
            ports = [tile.ports[p.name] for p in tile.core.inputs()
                     if p.width == g.width]
            if not ports:
                continue
            max_inputs = max(max_inputs, len(ports))
            supply = {src for p in ports for src in p.fan_in}
            if len(supply) < len(ports):
                yield _diag(
                    "static-routability", Severity.WARNING,
                    f"core has {len(ports)} input port(s) but the CB "
                    f"network delivers only {len(supply)} distinct "
                    "signal(s): apps using every port can never route "
                    "here",
                    g, tile=(x, y),
                    hint="raise num_tracks, cb_track_fc or cb_sides")
        w, h = g.dims()
        for axis, extent in (("x", w), ("y", h)):
            if extent < 2:
                continue
            cut = extent // 2
            coord = (lambda n: n.x) if axis == "x" else (lambda n: n.y)
            lo = hi = 0
            cores_lo = cores_hi = False
            for tile in g.tiles.values():
                if tile.core is not None:
                    if (tile.x if axis == "x" else tile.y) < cut:
                        cores_lo = True
                    else:
                        cores_hi = True
            for u, v, _delay in g.edges():
                cu, cv = coord(u), coord(v)
                if cu < cut <= cv:
                    lo += 1
                elif cv < cut <= cu:
                    hi += 1
            if not (cores_lo and cores_hi):
                continue
            for direction, crossing in (("->", lo), ("<-", hi)):
                if crossing == 0:
                    yield _diag(
                        "static-routability", Severity.ERROR,
                        f"no routing capacity {direction} across the "
                        f"middle {axis}-cut: cores on the two halves "
                        "can never communicate",
                        g,
                        hint="the inter-tile wiring is severed; check "
                             "insert_pipeline_registers coverage")
                elif crossing < max_inputs:
                    yield _diag(
                        "static-routability", Severity.WARNING,
                        f"only {crossing} wire(s) {direction} across "
                        f"the middle {axis}-cut but a core needs up to "
                        f"{max_inputs} operands: apps feeding it from "
                        "across the cut can never route",
                        g,
                        hint="raise num_tracks")

"""Routed-design analysis rules (``scope="routed"``).

PR 6's IR rules reject designs no configuration can save; these rules
audit one *configured* design point — ``(PackedGraph, RoutingResult,
RoutingResources, bitstream config)`` as produced by
:func:`repro_torch.core.pnr.place_and_route` — in milliseconds, before any
emulation minutes are spent:

========================  =====================================================
rule id                   what it rejects / reports
========================  =====================================================
``rv-deadlock``           Dally-style cycle on the channel dependency
                          graph of the routed ready-valid fabric with no
                          FIFO break (error), or buffered only by finite
                          FIFO capacity (warning: deadlocks once full)
``throughput-bound``      static initiation-interval lower bound from the
                          slowest registered loop over its min-cut FIFO
                          capacity; warns when a loop caps throughput,
                          errors when the bound exceeds a measured
                          emulated II (the bound must be a lower bound)
``sta-slack``             per-net slack against a target clock
                          (``analyze(..., clock_ns=...)``): negative
                          slack errors, a near-critical cluster warns
``congestion-hotspot``    routing-node overuse (two nets on one node:
                          the bitstream can only select one) and
                          per-tile switch-node utilization >= 90%
``x-propagation``         uninitialized-register reachability on the
                          configured fabric: a configured driver chain
                          that never reaches live data, or a route tree
                          edge with no physical fan-in behind it
========================  =====================================================

All five gate on the routed artifacts being present on the
:class:`AnalysisContext` (``analyze(..., pnr=result)``), so ``scope=
"all"`` sweeps stay safe on un-routed designs. A clean routed report is
zero findings — success is silent, metrics travel separately via
:func:`routed_static_metrics` (what the DSE executor stamps into store
records for the ``min_throughput`` / ``min_slack_ns`` search
objectives).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from ..graph import SwitchBoxNode
from .diagnostics import Diagnostic, Severity
from .framework import AnalysisContext, register_rule
from .flow import ChannelDepGraph, build_channel_graph
from .rules import _diag, _is_rv

#: reference clock for the stored ``min_slack_ns`` static metric (a
#: 100 MHz target): record-level slack must be comparable across design
#: points, so it is taken against one fixed period, not each point's own
#: critical path
DEFAULT_CLOCK_NS = 10.0

#: per-tile switch-node utilization at which congestion-hotspot warns
CONGESTION_WARN_UTILIZATION = 0.9

#: fraction of the target period under which a net counts near-critical
NEAR_CRITICAL_FRACTION = 0.1


def _has_routed(ctx: AnalysisContext) -> bool:
    return ctx.routing is not None and ctx.packed is not None


def _routed_rv(ctx: AnalysisContext) -> bool:
    return _has_routed(ctx) and _is_rv(ctx)


def _channel_graph(ctx: AnalysisContext) -> ChannelDepGraph:
    cdg = getattr(ctx, "_routed_cdg", None)
    if cdg is None:
        cdg = build_channel_graph(ctx.packed, ctx.routing)
        ctx._routed_cdg = cdg
    return cdg


def _cycle_sample(ctx: AnalysisContext, members: List[int]) -> str:
    nodes = ctx.routing.resources.nodes
    sample = ", ".join(repr(nodes[n]) for n in members[:3])
    return f"{sample}{', ...' if len(members) > 3 else ''}"


def _split_ctrl_delay(ctx: AnalysisContext) -> float:
    if ctx.spec is not None and ctx.spec.split_fifo_ctrl_delay:
        return float(ctx.spec.split_fifo_ctrl_delay)
    return 0.0


# ---------------------------------------------------------------------------
# rv-deadlock
# ---------------------------------------------------------------------------

@register_rule(
    "rv-deadlock",
    description="configured ready-valid channel-dependency cycle: "
                "unbuffered rings deadlock unconditionally, FIFO-"
                "buffered loops deadlock once their capacity fills",
    scope="routed",
    when=_routed_rv)
def rv_deadlock(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    """Dally's condition on the *routed* fabric: the IR-scope
    ``rv-handshake`` rule rejects structures where a deadlock is
    wired-in; this rule checks the one configuration PnR actually chose.
    Route-tree edges are wait-for dependencies (a flit holds a node
    until downstream accepts), PEs couple their input channels to their
    output channels, and ``rv_fifo`` stages are the cycle-breakers."""
    cdg = _channel_graph(ctx)
    nodes = ctx.routing.resources.nodes
    for members in cdg.unbuffered_cycles():
        yield _diag(
            "rv-deadlock", Severity.ERROR,
            f"configured handshake cycle through {len(members)} routed "
            f"node(s) with no FIFO stage: {_cycle_sample(ctx, members)}"
            " — the ready chain closes combinationally and the fabric "
            "deadlocks",
            node=nodes[members[0]],
            hint="re-route the loop through an rv_fifo register stage "
                 "(raise reg_density) or break the feedback in the app")
    for members, stages, capacity in cdg.buffered_cycles():
        yield _diag(
            "rv-deadlock", Severity.WARNING,
            f"FIFO-constrained channel-dependency cycle: {stages} FIFO "
            f"stage(s) provide {capacity} slot(s) of credit on a "
            f"{len(members)}-node loop ({_cycle_sample(ctx, members)}); "
            f"the loop deadlocks once {capacity} token(s) are trapped "
            "in flight",
            node=nodes[members[0]],
            hint="bound in-flight tokens below the loop capacity, or "
                 "use full-mode FIFOs for more credit per stage")


# ---------------------------------------------------------------------------
# throughput-bound
# ---------------------------------------------------------------------------

@register_rule(
    "throughput-bound",
    description="static initiation-interval lower bound from the "
                "slowest registered loop over its min-cut FIFO "
                "capacity, cross-checked against emulated throughput",
    scope="routed",
    when=_has_routed,
    default_severity=Severity.WARNING)
def throughput_bound(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    """An acyclic routed design streams one token per cycle (II = 1).
    A loop with S sequential stages and C total FIFO slots obeys
    II >= S / C; an unbuffered loop has no steady state at all. When
    the caller measured an emulated II (``timing["emulated_ii"]``),
    violating ``static <= emulated`` is an error: the static bound
    must be a true lower bound."""
    ii = static_ii_bound(ctx.packed, ctx.routing)
    if ii == float("inf"):
        yield _diag(
            "throughput-bound", Severity.ERROR,
            "no steady-state throughput: a configured loop has no FIFO "
            "credit (see rv-deadlock) — static II bound is infinite",
            hint="break or buffer the loop before emulating")
    elif ii > 1.0:
        yield _diag(
            "throughput-bound", Severity.WARNING,
            f"registered loop bounds the initiation interval: "
            f"II >= {ii:.2f} (slowest loop stages / min-cut FIFO "
            "capacity) — the app cannot accept one token per cycle",
            hint="add FIFO capacity on the loop (full-mode FIFOs or "
                 "more register stages) to lower the bound")
    emulated = (ctx.timing or {}).get("emulated_ii")
    if emulated is not None and ii != float("inf") \
            and ii > float(emulated) + 1e-9:
        yield _diag(
            "throughput-bound", Severity.ERROR,
            f"static II bound {ii:.2f} exceeds the emulated II "
            f"{float(emulated):.2f}: the 'lower bound' is not one — "
            "the channel-dependency model disagrees with the fabric",
            hint="file the routed design as an analyzer regression")


def static_ii_bound(packed, routing) -> float:
    """Static initiation-interval lower bound of one routed app: 1.0
    for acyclic channel graphs and non-handshake (static) fabrics —
    both stream fully pipelined — else the slowest-loop bound from
    :meth:`ChannelDepGraph.static_ii`."""
    ic = routing.resources.ic
    if not ic.params.get("rv_fifo_mode"):
        return 1.0
    return build_channel_graph(packed, routing).static_ii()


# ---------------------------------------------------------------------------
# sta-slack
# ---------------------------------------------------------------------------

@register_rule(
    "sta-slack",
    description="per-net slack against the target clock "
                "(analyze(..., clock_ns=...)): negative slack errors, "
                "near-critical clusters warn",
    scope="routed",
    when=_has_routed)
def sta_slack(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    """Full per-net slack histogram extending ``sta_critical_path``:
    every routed net sink gets ``slack = clock_ns - arrival``. Without
    a target clock there is no period to violate — the rule stays
    silent and the histogram remains available via
    :func:`repro_torch.core.pnr.timing.sta_net_slacks`."""
    if ctx.clock_ns is None:
        return
    from ..pnr.timing import sta_net_slacks
    table = sta_net_slacks(ctx.packed, ctx.routing, ctx.placement or {},
                           clock_ns=ctx.clock_ns,
                           split_fifo_ctrl_delay=_split_ctrl_delay(ctx))
    period = table["period_ns"]
    near = []
    for row in table["nets"]:
        if row["slack_ns"] < 0:
            yield _diag(
                "sta-slack", Severity.ERROR,
                f"net {row['net']!r} -> {row['sink']!r} arrives at "
                f"{row['arrival_ns']:.3f} ns against a {period:.3f} ns "
                f"clock: slack {row['slack_ns']:.3f} ns",
                hint="lower the clock target, re-route with a higher "
                     "alpha (timing-driven), or pipeline the path")
        elif row["slack_ns"] < NEAR_CRITICAL_FRACTION * period:
            near.append(row)
    if near:
        worst = near[0]
        yield _diag(
            "sta-slack", Severity.WARNING,
            f"{len(near)} net(s) within "
            f"{NEAR_CRITICAL_FRACTION:.0%} of the {period:.3f} ns "
            f"clock (worst: {worst['net']!r} at "
            f"{worst['arrival_ns']:.3f} ns, slack "
            f"{worst['slack_ns']:.3f} ns): little margin for wire "
            "variation",
            hint="inspect sta_net_slacks() for the near-critical "
                 "cluster before committing the clock")


# ---------------------------------------------------------------------------
# congestion-hotspot
# ---------------------------------------------------------------------------

@register_rule(
    "congestion-hotspot",
    description="routing-node overuse (illegal: one select per mux) "
                "and per-tile switch-node utilization margins",
    scope="routed",
    when=_has_routed,
    default_severity=Severity.WARNING)
def congestion_hotspot(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    """PathFinder legality audited after the fact, plus the congestion
    margin PathFinder does not report: a mux carries exactly one select
    value, so two nets on one node is a hard error, and a tile whose
    switch nodes are nearly all occupied has no slack for the next app
    or a rip-up — the per-tile track-utilization hotspot map."""
    res = ctx.routing.resources
    usage: Dict[int, int] = {}
    for net in ctx.routing.nets:
        for nid in net.nodes_used():
            usage[nid] = usage.get(nid, 0) + 1
    for nid in sorted(n for n, c in usage.items() if c > 1):
        yield _diag(
            "congestion-hotspot", Severity.ERROR,
            f"routing node used by {usage[nid]} nets but a mux select "
            "can express only one driver: the routing is illegal",
            node=res.nodes[nid],
            hint="the router left overuse behind — raise route_iters")
    total: Dict[Tuple[int, int], int] = {}
    used: Dict[Tuple[int, int], int] = {}
    for nid, node in enumerate(res.nodes):
        if not isinstance(node, SwitchBoxNode):
            continue
        key = (node.x, node.y)
        total[key] = total.get(key, 0) + 1
        if nid in usage:
            used[key] = used.get(key, 0) + 1
    for key in sorted(used):
        u, t = used[key], total[key]
        if t and u / t >= CONGESTION_WARN_UTILIZATION:
            yield _diag(
                "congestion-hotspot", Severity.WARNING,
                f"tile switch-node utilization {u}/{t} "
                f"({u / t:.0%}): only {t - u} node(s) of margin "
                "before the tile saturates",
                tile=key,
                hint="raise num_tracks or spread the placement "
                     "(higher sa_steps)")


# ---------------------------------------------------------------------------
# x-propagation
# ---------------------------------------------------------------------------

@register_rule(
    "x-propagation",
    description="uninitialized-register reachability on the configured "
                "fabric: a configured driver chain that never reaches "
                "live data",
    scope="routed",
    when=_has_routed)
def x_propagation(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    """The bitstream configures one driver per used node (the route-tree
    parent). A sink whose configured driver chain never terminates at
    the net's source — an orphaned or cyclic chain, or a tree edge with
    no physical fan-in behind it — observes whatever an uninitialized
    register or an undriven mux default happens to hold: X in silicon,
    reset garbage in emulation. Well-formed route trees can never
    trip this; it guards decoded/hand-edited bitstreams and router
    regressions."""
    res = ctx.routing.resources
    for net in ctx.routing.nets:
        for child in sorted(net.tree):
            parent = net.tree[child]
            if res.nodes[parent] not in res.nodes[child].fan_in:
                yield _diag(
                    "x-propagation", Severity.ERROR,
                    f"net {net.name!r}: configured driver "
                    f"{res.nodes[parent]!r} is not a physical fan-in of "
                    f"{res.nodes[child]!r} — no bitstream can express "
                    "this route",
                    node=res.nodes[child],
                    hint="the route tree was corrupted after routing "
                         "(or decoded from a foreign bitstream)")
        limit = len(net.tree) + 1
        for sink in sorted(net.sinks):
            node, steps = sink, 0
            while node != net.src and node in net.tree and steps < limit:
                node = net.tree[node]
                steps += 1
            if node != net.src:
                yield _diag(
                    "x-propagation", Severity.ERROR,
                    f"net {net.name!r}: sink {res.nodes[sink]!r}'s "
                    "configured driver chain never reaches the net "
                    "source — it reads uninitialized register / "
                    "undriven mux state",
                    node=res.nodes[sink],
                    hint="re-route the net; the tree is orphaned or "
                         "cyclic at this sink")


# ---------------------------------------------------------------------------
# static metrics for the store / search wiring
# ---------------------------------------------------------------------------

def routed_static_metrics(packed, routing, placement,
                          clock_ns: float = DEFAULT_CLOCK_NS,
                          core_delay: float = 0.8,
                          split_fifo_ctrl_delay: float = 0.0
                          ) -> Dict[str, float]:
    """The per-app static metrics the DSE executor stamps into store
    records (and :mod:`repro_torch.core.search.pareto` consumes with no extra
    PnR): ``static_ii`` (initiation-interval lower bound),
    ``throughput`` (its reciprocal, tokens/cycle; 0.0 when deadlocked)
    and ``min_slack_ns`` (worst per-net slack against the fixed
    ``clock_ns`` reference period, default {DEFAULT_CLOCK_NS} ns)."""
    from ..pnr.timing import sta_net_slacks
    ii = static_ii_bound(packed, routing)
    table = sta_net_slacks(packed, routing, placement or {},
                           clock_ns=clock_ns, core_delay=core_delay,
                           split_fifo_ctrl_delay=split_fifo_ctrl_delay)
    return {"static_ii": ii,
            "throughput": 0.0 if ii == float("inf") else 1.0 / ii,
            "min_slack_ns": float(table["min_slack_ns"])}

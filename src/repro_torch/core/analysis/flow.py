"""Channel-dependency-graph helper for the routed-scope analyses.

Dally's classic argument: a routed network deadlocks iff the *channel
dependency graph* — "an agent holding channel A waits for channel B" —
contains a cycle no buffer stage breaks. On Canal's hybrid ready-valid
fabric (paper §5) the channels are the configured routing nodes: a flit
occupies a mux/wire node until the downstream node accepts it, so every
configured edge (parent -> child of a route tree) is a wait-for
dependency, and a processing element couples its input channels to its
output channels (it holds operands until the result is accepted). FIFO
stages (``rv_fifo``-tagged registers, lowered to depth-1/2 FIFOs by
:class:`repro_torch.fabric.RVFabric`) decouple the handshake: they are the
cycle-breakers.

Two verdicts fall out of the same graph:

* a cycle that remains after removing every FIFO node is a
  *combinational handshake ring* — the ready chain closes on itself with
  zero buffering, the hard deadlock ``rv-deadlock`` rejects;
* a cycle broken only by FIFOs still bounds throughput: with ``S``
  sequential stages and total capacity ``C`` slots, a token needs at
  least ``S`` cycles per lap and at most ``C`` tokens are in flight, so
  the initiation interval obeys ``II >= S / C`` (and the loop deadlocks
  outright once ``C`` tokens are trapped in it). ``throughput-bound``
  turns that into a static lower bound on the emulated II.

Everything here is pure data-plumbing over ``(PackedGraph,
RoutingResult, RoutingResources)`` — the rules in
:mod:`repro_torch.core.analysis.routed` wrap it in diagnostics.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from ..graph import NodeKind


@dataclass
class ChannelDepGraph:
    """The channel dependency graph of one routed application: node ids
    are :class:`RoutingResources` fine-node ids, edges follow the
    configured data flow (route-tree parent -> child, plus PE
    input-sink -> output-source coupling), and ``fifo_capacity`` maps
    each FIFO stage on the used graph to its slot count."""

    #: every routing node used by some net (tree nodes + sources)
    used: Set[int] = field(default_factory=set)
    #: configured wait-for edges, src -> [dst]
    adj: Dict[int, List[int]] = field(default_factory=dict)
    #: FIFO stage node id -> buffer slots (0 never appears: a register
    #: with no credit is not a cycle-breaker and is simply absent here)
    fifo_capacity: Dict[int, int] = field(default_factory=dict)

    def add_edge(self, src: int, dst: int) -> None:
        self.adj.setdefault(src, []).append(dst)

    def sccs(self) -> List[List[int]]:
        """Cyclic strongly-connected components (size > 1 or self-loop),
        deterministic order."""
        return list(_cyclic_sccs(self.adj, sorted(self.used)))

    def unbuffered_cycles(self) -> List[List[int]]:
        """Cycles that survive removing every FIFO stage — the Dally
        deadlock condition with FIFO capacities as cycle-breakers."""
        out: List[List[int]] = []
        for scc in self.sccs():
            members = set(scc) - set(self.fifo_capacity)
            sub = {n: [m for m in self.adj.get(n, []) if m in members]
                   for n in members}
            out.extend(_cyclic_sccs(sub, sorted(members)))
        return out

    def buffered_cycles(self) -> List[Tuple[List[int], int, int]]:
        """Cycles every path of which crosses a FIFO stage, as
        ``(scc_nodes, fifo_stages, total_capacity)`` — the throughput-
        limiting (but deadlock-free while under capacity) loops."""
        out: List[Tuple[List[int], int, int]] = []
        for scc in self.sccs():
            fifos = [n for n in scc if n in self.fifo_capacity]
            members = set(scc) - set(self.fifo_capacity)
            sub = {n: [m for m in self.adj.get(n, []) if m in members]
                   for n in members}
            if fifos and not list(_cyclic_sccs(sub, sorted(members))):
                out.append((scc, len(fifos),
                            sum(self.fifo_capacity[n] for n in fifos)))
        return out

    def static_ii(self) -> float:
        """Static initiation-interval lower bound of this routed app:
        1.0 when the channel dependency graph is acyclic (fully
        pipelined — one token per cycle), ``S / C`` per buffered loop
        (slowest registered loop over its min-cut FIFO capacity,
        clamped at 1.0), ``inf`` when an unbuffered handshake ring
        makes any steady throughput impossible."""
        if self.unbuffered_cycles():
            return float("inf")
        ii = 1.0
        for _, stages, capacity in self.buffered_cycles():
            ii = max(ii, stages / max(capacity, 1))
        return ii


def fifo_depth_of(ic) -> int:
    """Per-stage FIFO slots of the lowered ready-valid fabric: the
    ``readyvalid_transform`` pass records the mode on the IR, and the
    lowering maps full -> depth 2, split -> depth 1 (paper Fig. 6)."""
    return 2 if ic.params.get("rv_fifo_mode", "full") == "full" else 1


def build_channel_graph(packed, routing,
                        fifo_depth: Optional[int] = None
                        ) -> ChannelDepGraph:
    """Build the channel dependency graph of a routed application.

    ``packed`` is the :class:`repro_torch.core.pnr.packing.PackedGraph`,
    ``routing`` the :class:`repro_torch.core.pnr.route.RoutingResult`;
    ``fifo_depth`` overrides the per-stage capacity (default: derived
    from the IR's ``rv_fifo_mode``)."""
    res = routing.resources
    if fifo_depth is None:
        fifo_depth = fifo_depth_of(res.ic)
    cdg = ChannelDepGraph()
    net_by_name = {n.name: n for n in routing.nets}
    # instance coupling tables: which routed nodes feed / leave each
    # placeable instance
    inst_in: Dict[str, List[int]] = {}
    inst_out: Dict[str, List[int]] = {}
    for net in routing.nets:
        cdg.used |= net.nodes_used()
        for parent, child in net.edges():
            cdg.add_edge(parent, child)
    for net in packed.nets:
        rnet = net_by_name.get(net.name)
        if rnet is None:
            continue
        inst_out.setdefault(net.src[0], []).append(rnet.src)
        for (sink_inst, _), sink_id in zip(net.sinks, rnet.sinks):
            inst_in.setdefault(sink_inst, []).append(sink_id)
    # a PE holds its input channels until its output is accepted: the
    # wait-for dependency crosses the core
    for inst in inst_in:
        for src_id in inst_out.get(inst, []):
            for sink_id in inst_in[inst]:
                cdg.add_edge(sink_id, src_id)
    for nid in cdg.used:
        node = res.nodes[nid]
        if (node.kind == NodeKind.REGISTER
                and node.attributes.get("rv_fifo")):
            cdg.fifo_capacity[nid] = fifo_depth
    return cdg


def _cyclic_sccs(adj: Dict[int, List[int]],
                 nodes: Sequence[int]) -> Iterator[List[int]]:
    """Cyclic strongly-connected components of an integer adjacency map
    (iterative Tarjan — routed node sets reach 10^4+, recursion would
    blow the stack). Yields only SCCs that contain a cycle: size > 1,
    or a node with a self-loop."""
    index: Dict[int, int] = {}
    low: Dict[int, int] = {}
    on_stack: Set[int] = set()
    stack: List[int] = []
    counter = 0
    for root in nodes:
        if root in index:
            continue
        work: List[Tuple[int, int]] = [(root, 0)]
        while work:
            n, ei = work[-1]
            if ei == 0:
                index[n] = low[n] = counter
                counter += 1
                stack.append(n)
                on_stack.add(n)
            succ = adj.get(n, ())
            advanced = False
            while ei < len(succ):
                m = succ[ei]
                ei += 1
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
                scc: List[int] = []
                while True:
                    m = stack.pop()
                    on_stack.discard(m)
                    scc.append(m)
                    if m == n:
                        break
                if len(scc) > 1 or n in adj.get(n, ()):
                    yield sorted(scc)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[n])

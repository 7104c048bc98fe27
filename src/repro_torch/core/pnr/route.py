"""Negotiated-congestion routing (§3.4): PathFinder-style iteration with A*.

"During each iteration, we compute the slack on a net and determine how
critical it is given global timing information. Then we route using the A*
algorithm on the weighted graph. The weights for each edge are based on
historical usage, net slack, and current congestion."

The router works directly on the interconnect IR (Fig. 7): edge weights are
the IR's embedded delays; congestion terms are negotiated over iterations;
net criticality (delay / max delay of the previous iteration) blends the
congestion cost with the pure-delay cost.

Two-level routing scheme (``strategy=`` knob on :func:`route_nets`):

``"python"``
    The oracle: pure-Python A* over the fine IR graph with a Manhattan
    lower bound. Exact, dependency-free, and the semantics every other
    strategy is measured against.

``"minplus"``
    Device-batched coarse wavefronts feeding the same fine expander. Per
    PathFinder iteration the router tile-coarsens the congestion-weighted
    graph (one node per tile, crossing-edge weights reduced to their
    cheapest member, inf-padded to 128 blocks), then runs ONE batched
    tropical Bellman-Ford fixpoint (``repro_torch.kernels.minplus``) seeded at
    every distinct sink tile of every net being (re)routed. Each resulting
    cost field is an *admissible* A* lower bound: a coarse edge weight is
    ``min(delay-part, congestion-part)`` of the cheapest fine crossing
    edge — a lower bound of the blended fine cost for any net criticality
    — plus the source tile's transit toll (the cheapest exit node's base
    cost; refunded per-node for nodes that are themselves exits), while
    all other intra-tile moves cost 0: no fine path can be cheaper than
    the coarse field says. The expander adds a small per-remaining-tile
    hop bias on top (``_MINPLUS_HOP_BIAS``) that collapses equal-cost
    plateaus into a directed dive and steers ties toward fewer-hop,
    lower-wire-delay trees, so routes are cost-optimal up to a bounded
    few-percent premium while expanding far fewer nodes (the field
    prices in mux delays, register penalties and congestion history that
    the Manhattan bound ignores) and pruning coarse-unreachable tiles
    outright.
    The coarse structure is built once per :class:`RoutingResources` and
    cached; per iteration only the congestion weights are refreshed, and
    the history-free fields of iteration 0 are memoized per sink tile
    across calls (α sweeps re-route the same sinks).

``"auto"``
    ``"minplus"`` on fabrics with at least ``_AUTO_MIN_TILES`` tiles,
    ``"python"`` below — coarse fields only pay for themselves once the
    search space is big enough.

When each strategy wins: ``python`` on tiny fabrics (< ~7x7, where field
setup dominates) and as the differential oracle; ``minplus`` everywhere
else — the ≥8x8 DSE sweeps route the same trees legality-identically at a
multiple of the nets/sec (see ``benchmarks/pnr_speed.py``).
"""
from __future__ import annotations

import heapq
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.graph import (Interconnect, Node, NodeKind)
from repro_torch.core.tiles import IO_BIT_IN, IO_BIT_OUT
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import span
from .packing import PackedGraph

_log = logging.getLogger(__name__)


class RoutingError(RuntimeError):
    pass


#: value used for "no coarse edge" — matches repro_torch.kernels.minplus.INF
#: (float32-safe: two of these still add without overflowing to inf)
COARSE_INF = 3.0e38 / 4
#: anything above this is treated as coarse-unreachable
_INF_CUT = COARSE_INF / 2
#: "auto" strategy switches to the device-batched coarse fields at this
#: many tiles (~7x7): below, field setup costs more than it prunes.
#: Default only — override per process via the CANAL_AUTO_MIN_TILES env
#: var or per design point via InterconnectSpec.auto_min_tiles (plumbed
#: through route_nets/route_app/place_and_route ``auto_min_tiles=``).
_AUTO_MIN_TILES = 49


def auto_min_tiles_threshold(override: Optional[int] = None) -> int:
    """Resolve the "auto" strategy tile threshold: explicit override >
    ``CANAL_AUTO_MIN_TILES`` env var > module default. The env var exists
    so the ROADMAP calibration item can re-run sweeps at candidate
    thresholds without code edits."""
    if override is not None:
        return int(override)
    env = os.environ.get("CANAL_AUTO_MIN_TILES")
    if env:
        try:
            return int(env)
        except ValueError:
            _log.warning("ignoring non-integer CANAL_AUTO_MIN_TILES=%r",
                         env)
    return _AUTO_MIN_TILES
#: hop bias of the minplus expander, as a fraction of ``hop_cost`` per
#: remaining Manhattan tile: f = g + h + bias·manhattan. With a
#: near-exact h every monotone staircase between source and sink ties
#: within float ulps and plain A* floods that whole rectangle; the bias
#: makes nodes nearer the sink strictly preferred (collapsing the
#: plateau into a dive) *and* steers equal-cost ties toward fewer-hop —
#: lower wire-delay — trees. Cost premium is bounded by
#: bias·hop_cost·manhattan(src, sink), a few percent of a typical path,
#: which PathFinder's negotiation absorbs (the differential suite bounds
#: the delay drift at 10%).
_MINPLUS_HOP_BIAS = 0.05


# Port-name normalization for instances whose kind changed during packing
# (unpacked registers become pass-through PEs).
_PORT_ALIAS = {"out": "res0", "in": "data0"}


def fabric_port(kind: str, port: str) -> str:
    """The core port an app instance's net ``port`` lands on: an
    ``io_in`` drives through the IO tile's ``io_out`` (or its 1-bit
    ``io2f_1``), an ``io_out`` is driven on ``io_in`` (or ``f2io_1``);
    other ports keep their names (``_PORT_ALIAS`` for unpacked
    registers)."""
    if kind == "io_in":
        return port if port == IO_BIT_OUT else "io_out"
    if kind == "io_out":
        return port if port == IO_BIT_IN else "io_in"
    return _PORT_ALIAS.get(port, port)


def port_width(ic: Interconnect, x: int, y: int, name: str) -> int:
    """The width of the core port ``name`` at tile (x, y): the layer its
    net routes on."""
    tile = ic.graph(ic.widths[-1]).get_tile(x, y)
    core = tile.core if tile is not None else None
    for p in (core.ports if core is not None else ()):
        if p.name == name:
            return p.width
    raise RoutingError(f"no port {name} at tile ({x},{y})")


class RoutingResources:
    """Array view of the IR for the router: ids, adjacency, costs.

    ``device`` is where the ``"minplus"`` cost fields are computed
    (``None``: the CUDA card, resolved when a field is first needed)."""

    def __init__(self, ic: Interconnect, reg_penalty: float = 4.0,
                 device: DeviceLike = None):
        with span("pnr.resources"):
            self.ic = ic
            self.reg_penalty = reg_penalty
            self.device = device
            self.nodes: List[Node] = list(ic.nodes())
            self.node_id: Dict[Node, int] = {n: i for i, n in
                                             enumerate(self.nodes)}
            n = len(self.nodes)
            adj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
            # one pass builds every destination's fan-in position map, so the
            # edge loop below is O(E) instead of the old O(E * max_fanin)
            # (``dst.fan_in.index(node)`` per edge)
            fanin_pos: Dict[Node, Dict[Node, int]] = {
                node: {s: k for k, s in enumerate(node.fan_in)}
                for node in self.nodes}
            #: (src_id, dst_id) -> wire delay of that edge (STA / net delay)
            self.edge_delay_map: Dict[Tuple[int, int], float] = {}
            min_hop = np.inf
            for i, node in enumerate(self.nodes):
                for dst in node.fan_out:
                    j = self.node_id[dst]
                    k = fanin_pos[dst][node]
                    wire = dst.edge_delay_in[k]
                    d = wire + dst.delay
                    adj[i].append((j, d))
                    self.edge_delay_map[(i, j)] = wire
                    if d > 0:
                        min_hop = min(min_hop, d)
            self.adj = adj
            self.kind = np.array([int(nd.kind) for nd in self.nodes], np.int8)
            self.xy = np.array([(nd.x, nd.y) for nd in self.nodes], np.int32)
            # base node cost: intrinsic delay + epsilon, registers discouraged
            # (keeps routed paths combinational unless pipelining is requested)
            eps = 1e-3
            self.base = np.array([
                nd.delay + eps + (reg_penalty
                                  if nd.kind == NodeKind.REGISTER else 0.0)
                for nd in self.nodes], np.float64)
            self.hop_cost = float(min_hop if np.isfinite(min_hop) else 0.1)
            # plain-list coordinates: the minplus expander's hop bias reads
            # them per heap push, where list indexing beats numpy scalars
            self.x_list: List[int] = self.xy[:, 0].tolist()
            self.y_list: List[int] = self.xy[:, 1].tolist()
            self._coarse: Optional["CoarseGraph"] = None

    def coarse(self) -> "CoarseGraph":
        """The tile-coarsened view, built once and cached (per-iteration
        congestion weights are refreshed on top of this structure)."""
        if self._coarse is None:
            self._coarse = CoarseGraph(self)
        return self._coarse

    def port(self, x: int, y: int, name: str, width: int) -> int:
        g = self.ic.graph(width)
        tile = g.get_tile(x, y)
        if tile is None or name not in tile.ports:
            raise RoutingError(f"no port {name} at tile ({x},{y})")
        return self.node_id[tile.get_port(name)]


class CoarseGraph:
    """Tile-coarsened routing graph for the batched min-plus wavefronts.

    One coarse node per (x, y) tile; a coarse edge between two tiles
    carries the cheapest lower bound over all fine edges crossing between
    them. Only the static structure (crossing-edge index arrays) lives
    here — congestion weights are recomputed per PathFinder iteration by
    :meth:`lower_bound_weights`, and the dense matrix handed to the
    device is rebuilt from cached indices in O(E_crossing).
    """

    def __init__(self, res: RoutingResources):
        xy = res.xy
        if len(xy) == 0:
            raise RoutingError("cannot coarsen an empty routing graph")
        x0, y0 = int(xy[:, 0].min()), int(xy[:, 1].min())
        self.gw = int(xy[:, 0].max()) - x0 + 1
        self.gh = int(xy[:, 1].max()) - y0 + 1
        self.n_tiles = self.gw * self.gh
        #: fine node id -> coarse tile id
        self.tile_of = ((xy[:, 1] - y0) * self.gw
                        + (xy[:, 0] - x0)).astype(np.int32)
        srcs: List[int] = []
        dsts: List[int] = []
        statics: List[float] = []
        dst_nodes: List[int] = []
        #: node has at least one fine edge leaving its tile
        self.is_exit = np.zeros(len(res.nodes), bool)
        for i, nbrs in enumerate(res.adj):
            ti = int(self.tile_of[i])
            for j, d in nbrs:
                tj = int(self.tile_of[j])
                if ti == tj:
                    continue
                self.is_exit[i] = True
                srcs.append(ti)
                dsts.append(tj)
                # delay part of the blended fine cost: d + base[dst]
                statics.append(d + res.base[j])
                dst_nodes.append(j)
        self.e_src_tile = np.asarray(srcs, np.int32)
        self.e_dst_tile = np.asarray(dsts, np.int32)
        self.e_static = np.asarray(statics, np.float64)
        self.e_dst_node = np.asarray(dst_nodes, np.int32)
        # transit toll: leaving tile t costs at least the cheapest
        # exit node's own arrival cost (``base`` bounds the blended cost
        # for every criticality and congestion state). Charged on the
        # crossing's source side; nodes that *are* exits get it refunded
        # in sink_cost_fields, so the bound stays admissible — PROVIDED
        # no crossing lands directly on an exit node (true for SB-based
        # fabrics, where crossings terminate on SB_IN nodes with only
        # intra-tile fan-out). A graph that violates that (e.g. a torus
        # of chip nodes, every node both entry and exit) could transit a
        # tile through its entry node alone, and the toll would double-
        # charge it: drop the toll there, keeping the fields admissible
        # at the price of a looser bound.
        self.exit_toll = np.full(self.n_tiles, COARSE_INF, np.float64)
        exits = np.nonzero(self.is_exit)[0]
        if len(exits):
            np.minimum.at(self.exit_toll, self.tile_of[exits],
                          res.base[exits])
        if len(self.e_dst_node) and self.is_exit[self.e_dst_node].any():
            self.exit_toll[:] = 0.0
        #: history-free cost fields memoized per sink tile (iteration-0
        #: fields depend only on the static graph, so α sweeps and
        #: repeated apps on the same fabric reuse them across calls);
        #: _base_lists additionally memoizes the refund-adjusted per-node
        #: Python lists A* consumes (the tolist conversion is hot)
        self._base_rows: Dict[int, np.ndarray] = {}
        self._base_lists: Dict[int, List[float]] = {}

    def lower_bound_weights(self, cost_lb: np.ndarray) -> np.ndarray:
        """Dense (n_tiles, n_tiles) coarse adjacency of per-crossing lower
        bounds: ``min(delay_part, congestion_part)`` minimized over the
        fine edges of each tile pair, plus the source tile's transit toll
        (every fine path must pay its cheapest exit node before leaving);
        0 on the diagonal (intra-tile moves are otherwise free in the
        coarse model — underestimates, stays admissible).

        ``cost_lb`` must itself lower-bound the per-node negotiated cost
        for every net of the iteration (callers pass
        ``base * (1 + hist_w * hist)``, dropping the intra-iteration
        present-usage term)."""
        w = np.full((self.n_tiles, self.n_tiles), COARSE_INF, np.float64)
        if len(self.e_static):
            lb = np.minimum(self.e_static, cost_lb[self.e_dst_node])
            np.minimum.at(w, (self.e_src_tile, self.e_dst_tile), lb)
            has_exit = self.exit_toll < COARSE_INF
            w[has_exit] += self.exit_toll[has_exit, None]
        np.fill_diagonal(w, 0.0)
        return w

    def sink_cost_fields(self, res: RoutingResources, sinks: Sequence[int],
                         hist: np.ndarray, hist_w: float
                         ) -> Dict[int, np.ndarray]:
        """Per-sink admissible heuristic arrays, batched on device.

        One batched tropical Bellman-Ford fixpoint covers every distinct
        sink *tile* at once (lane b seeded 0 at its tile, INF elsewhere,
        relaxed over the transposed coarse weights = cost *to* the sink);
        the per-tile rows are then expanded to per-fine-node arrays.
        Nodes that are themselves tile exits get the transit toll of
        their own tile refunded: they can take a crossing edge directly,
        without first paying for an intra-tile hop to an exit.
        Returns {sink node id: (n_nodes,) per-node lower bounds} as
        Python lists (what the A* inner loop indexes fastest), memoized
        per sink tile for the history-free case."""
        tiles = sorted({int(self.tile_of[s]) for s in sinks})
        zero_hist = not hist.any()
        if zero_hist:
            missing = [t for t in tiles if t not in self._base_rows]
        else:
            missing = tiles
        rows: Dict[int, np.ndarray] = {}
        if missing:
            from repro_torch.kernels import ops as kops

            dev = resolve_device(res.device)
            w = self.lower_bound_weights(
                res.base * (1.0 + hist_w * hist))
            # bucket the seed batch to a power of two, as the reference
            # does (its jitted relaxation keys its trace on the batch
            # size); padding lanes stay all-INF and converge immediately
            bucket = 1
            while bucket < len(missing):
                bucket *= 2
            d0 = np.full((bucket, self.n_tiles), COARSE_INF, np.float32)
            d0[np.arange(len(missing)), missing] = 0.0
            out = kops.minplus_wavefront(
                torch.from_numpy(d0).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    w.T.astype(np.float32))).to(dev))
            out = out.cpu().numpy().astype(np.float64)
            for row, t in zip(out, missing):
                rows[t] = row
                if zero_hist:
                    self._base_rows[t] = row
        if zero_hist:
            for t in tiles:
                rows.setdefault(t, self._base_rows[t])
        refund = np.where(self.is_exit, self.exit_toll[self.tile_of], 0.0)
        lists: Dict[int, List[float]] = {}
        for t in tiles:
            if zero_hist and t in self._base_lists:
                lists[t] = self._base_lists[t]
                continue
            lists[t] = np.maximum(rows[t][self.tile_of] - refund,
                                  0.0).tolist()
            if zero_hist:
                self._base_lists[t] = lists[t]
        return {int(s): lists[int(self.tile_of[s])] for s in sinks}


@dataclass
class RoutedNet:
    name: str
    src: int
    sinks: List[int]
    #: route tree as child -> parent node ids
    tree: Dict[int, int] = field(default_factory=dict)
    delay: float = 0.0

    def nodes_used(self) -> Set[int]:
        used = set(self.tree.keys()) | {self.src}
        return used

    def edges(self) -> List[Tuple[int, int]]:
        return [(p, c) for c, p in self.tree.items()]


@dataclass
class RoutingResult:
    nets: List[RoutedNet]
    iterations: int
    overuse_history: List[int]
    resources: RoutingResources
    #: the engine that actually routed ("python"/"minplus" — "auto" is
    #: resolved before routing starts and recorded here)
    strategy: str = "python"

    def all_edges_nodes(self) -> List[Tuple[Node, Node]]:
        out = []
        for net in self.nets:
            for p, c in net.edges():
                out.append((self.resources.nodes[p],
                            self.resources.nodes[c]))
        return out

    def total_wirelength(self) -> int:
        return sum(len(net.tree) for net in self.nets)


def _astar(res: RoutingResources, sources: Dict[int, float], sink: int,
           cost_of: np.ndarray, crit: float, own_nodes: Set[int],
           blocked: np.ndarray,
           tie: Optional[np.ndarray] = None,
           h_arr: Optional[Sequence[float]] = None) -> Optional[List[int]]:
    """A* from a set of sources (the net's current route tree) to one sink.
    cost_of: per-node negotiated cost; crit blends congestion vs delay.
    ``tie`` is a node permutation used as the tertiary heap key, so
    equal-cost expansions pop in a seed-reproducible order.

    ``h_arr`` replaces the Manhattan bound with a precomputed per-node
    lower bound (the device-batched coarse min-plus field); entries at or
    above ``_INF_CUT`` mark coarse-unreachable nodes, pruned outright.
    Because that bound is near-exact, a small per-remaining-tile hop bias
    (``_MINPLUS_HOP_BIAS``) is added on top: it collapses the equal-cost
    staircase plateau into a directed dive and prefers fewer-hop (lower
    wire-delay) representatives among equal-cost trees, at a bounded
    cost premium of ``bias·hop_cost`` per tile of separation."""
    tx, ty = res.xy[sink]
    h_scale = res.hop_cost * 0.5     # admissible-ish under negotiation
    if tie is None:
        tie = np.arange(len(res.nodes))
    g_sign = 1.0 if h_arr is None else -1.0

    if h_arr is None:
        def h(i: int) -> float:
            x, y = res.xy[i]
            return (abs(int(x) - int(tx)) + abs(int(y) - int(ty))) * h_scale
    else:
        bias = res.hop_cost * _MINPLUS_HOP_BIAS
        xs, ys = res.x_list, res.y_list
        txi, tyi = int(tx), int(ty)

        def h(i: int) -> float:
            return h_arr[i] + (abs(xs[i] - txi) + abs(ys[i] - tyi)) * bias

    dist: Dict[int, float] = {}
    came: Dict[int, int] = {}
    pq: List[Tuple[float, float, int, int]] = []
    for s, c0 in sources.items():
        if h_arr is not None and h_arr[s] >= _INF_CUT:
            continue                      # cannot reach the sink from here
        dist[s] = c0
        heapq.heappush(pq, (c0 + h(s), g_sign * c0, int(tie[s]), s))
    while pq:
        f, sg, _, u = heapq.heappop(pq)
        g = g_sign * sg
        if u == sink:
            path = [u]
            while u in came:
                u = came[u]
                path.append(u)
            path.reverse()
            return path
        if g > dist.get(u, np.inf):
            continue
        for v, d in res.adj[u]:
            if v != sink:
                if blocked[v] and v not in own_nodes:
                    continue
                # ports are endpoints, never pass-throughs
                if res.kind[v] == int(NodeKind.PORT):
                    continue
            if h_arr is not None and h_arr[v] >= _INF_CUT:
                continue
            w = crit * (d + res.base[v]) + (1.0 - crit) * cost_of[v]
            ng = g + w
            if ng < dist.get(v, np.inf) - 1e-12:
                dist[v] = ng
                came[v] = u
                heapq.heappush(pq, (ng + h(v), g_sign * ng, int(tie[v]), v))
    return None


def _resolve_strategy(res: RoutingResources, strategy: str,
                      auto_min_tiles: Optional[int] = None) -> str:
    if strategy in ("python", "minplus"):
        return strategy
    if strategy == "auto":
        threshold = auto_min_tiles_threshold(auto_min_tiles)
        n_tiles = res.coarse().n_tiles
        picked = "minplus" if n_tiles >= threshold else "python"
        # logged (and recorded on RoutingResult.strategy) so DSE sweeps
        # produce the calibration data the ROADMAP item asks for
        _log.info("route strategy auto -> %s (%d tiles, threshold %d)",
                  picked, n_tiles, threshold)
        return picked
    # deliberately NOT a RoutingError: place_and_route treats those as
    # ordinary routing failures (unroutable design points), which would
    # silently turn a config typo into an all-failed sweep
    raise ValueError(f"unknown routing strategy {strategy!r}")


def route_nets(res: RoutingResources,
               nets: List[Tuple[str, int, List[int]]],
               max_iters: int = 40, pres_fac0: float = 0.6,
               pres_growth: float = 1.5, hist_w: float = 0.4,
               seed: int = 0,
               node_capacity: Optional[np.ndarray] = None,
               strategy: str = "python",
               auto_min_tiles: Optional[int] = None) -> RoutingResult:
    """PathFinder negotiation over (name, src, sinks) nets.

    ``seed`` drives the deterministic tie-break permutation used by A*
    when several expansions have equal cost, so DSE callers get
    reproducible (and seed-variable) routes.

    node_capacity: per-node net capacity (default 1; >1 models virtual
    channels, e.g. the pod-fabric ICI model).

    ``strategy``: ``"python"`` (Manhattan-bounded A*, the oracle),
    ``"minplus"`` (device-batched coarse cost fields as A* lower bounds;
    see the module docstring), or ``"auto"`` (tile-count switch at
    ``auto_min_tiles`` — defaulting to the CANAL_AUTO_MIN_TILES env var,
    then ``_AUTO_MIN_TILES``; the resolved pick is logged and recorded on
    ``RoutingResult.strategy``)."""
    strat = _resolve_strategy(res, strategy, auto_min_tiles)
    n = len(res.nodes)
    tie = np.random.default_rng(seed).permutation(n)
    usage = np.zeros(n, np.int32)
    hist = np.zeros(n, np.float64)
    cap = (np.ones(n, np.int32) if node_capacity is None
           else node_capacity.astype(np.int32))
    routed: Dict[str, RoutedNet] = {}
    crit: Dict[str, float] = {name: 0.0 for name, _, _ in nets}
    overuse_hist: List[int] = []
    # endpoints are exclusively owned: block them for every other net
    endpoint_owner = np.full(n, -1, np.int32)
    for k, (_, src, sinks) in enumerate(nets):
        for e in [src] + sinks:
            if endpoint_owner[e] not in (-1, k):
                raise RoutingError("two nets share an endpoint node")
            endpoint_owner[e] = k

    pres_fac = pres_fac0
    for it in range(max_iters):
        over_pen = 1.0 + pres_fac * np.maximum(usage + 1 - cap, 0)
        cost_of = res.base * (1.0 + hist_w * hist) * over_pen
        to_route = [k for k, (name, _, _) in enumerate(nets)
                    if it == 0 or _net_overused(routed.get(name), usage,
                                                cap)]
        if it > 0 and not to_route:
            break
        # one batched device fixpoint prices every sink of the iteration
        h_fields: Dict[int, List[float]] = {}
        if strat == "minplus":
            all_sinks = [s for k in to_route for s in nets[k][2]]
            if all_sinks:
                h_fields = res.coarse().sink_cost_fields(
                    res, all_sinks, hist, hist_w)
        for k in to_route:
            name, src, sinks = nets[k]
            old = routed.pop(name, None)
            if old is not None:
                for nid in old.nodes_used():
                    usage[nid] -= 1
            over_pen = 1.0 + pres_fac * np.maximum(usage + 1 - cap, 0)
            cost_of = res.base * (1.0 + hist_w * hist) * over_pen
            blocked = (endpoint_owner >= 0) & (endpoint_owner != k)
            net = RoutedNet(name, src, list(sinks))
            tree_nodes: Dict[int, float] = {src: 0.0}
            own: Set[int] = {src}
            def _span(s):
                return (-abs(res.xy[s][0] - res.xy[src][0])
                        - abs(res.xy[s][1] - res.xy[src][1]))

            for sink in sorted(sinks, key=_span):
                path = _astar(res, tree_nodes, sink, cost_of,
                              crit.get(name, 0.0), own, blocked, tie=tie,
                              h_arr=h_fields.get(sink))
                if path is None:
                    raise RoutingError(
                        f"unroutable net {name} -> {res.nodes[sink]} "
                        f"(iteration {it})")
                for a, b in zip(path, path[1:]):
                    if b not in net.tree:
                        net.tree[b] = a
                for nid in path:
                    tree_nodes.setdefault(nid, 0.0)
                    own.add(nid)
            for nid in net.nodes_used():
                usage[nid] += 1
            routed[name] = net

        over = int(np.sum(np.maximum(usage - cap, 0)))
        overuse_hist.append(over)
        if over == 0:
            break
        hist += np.maximum(usage - cap, 0)
        pres_fac *= pres_growth
        # update criticalities from current delays
        delays = {}
        for name, netr in routed.items():
            netr.delay = _net_delay(res, netr)
            delays[name] = netr.delay
        dmax = max(delays.values()) if delays else 1.0
        for name in delays:
            crit[name] = min(0.9, delays[name] / max(dmax, 1e-9))
    else:
        over = int(np.sum(np.maximum(usage - cap, 0)))
        if over:
            raise RoutingError(
                f"congestion not resolved after {max_iters} iterations "
                f"({over} overused nodes)")

    result_nets = []
    for name, src, sinks in nets:
        netr = routed[name]
        netr.delay = _net_delay(res, netr)
        result_nets.append(netr)
    return RoutingResult(result_nets, len(overuse_hist), overuse_hist, res,
                         strategy=strat)


def _net_overused(net: Optional[RoutedNet], usage: np.ndarray,
                  cap: np.ndarray) -> bool:
    if net is None:
        return True
    return any(usage[nid] > cap[nid] for nid in net.nodes_used())


def _net_delay(res: RoutingResources, net: RoutedNet) -> float:
    """Max source->sink delay along the route tree."""
    memo: Dict[int, float] = {net.src: res.base[net.src]}

    def delay_to(nid: int) -> float:
        if nid in memo:
            return memo[nid]
        parent = net.tree[nid]
        d = (delay_to(parent) + res.nodes[nid].delay
             + res.edge_delay_map[(parent, nid)])
        memo[nid] = d
        return d

    return max((delay_to(s) for s in net.sinks), default=0.0)


def route_app(ic: Interconnect, packed: PackedGraph,
              placement: Dict[str, Tuple[int, int]],
              width: int = 16, max_iters: int = 40,
              res: Optional[RoutingResources] = None,
              seed: int = 0, strategy: str = "python",
              auto_min_tiles: Optional[int] = None) -> RoutingResult:
    """Route a packed+placed application on the interconnect: each net on
    the layer of its source port's width (a 1-bit net on the 1-bit
    layer). A sink port of another width than its source's raises
    ValueError."""
    if res is None:
        res = RoutingResources(ic)

    def port_of(inst_name: str, port: str) -> Tuple[int, int]:
        inst = packed.placeable[inst_name]
        x, y = placement[inst_name]
        pname = fabric_port(inst.kind, port)
        width = port_width(ic, x, y, pname)
        return res.port(x, y, pname, width), width

    nets = []
    for net in packed.nets:
        if net.src[0] not in packed.placeable:
            continue
        src, width = port_of(net.src[0], net.src[1])
        sinks = []
        for s, p in net.sinks:
            if s not in packed.placeable:
                continue
            sink, w = port_of(s, p)
            if w != width:
                raise ValueError(
                    f"net {net.name}: {net.src[0]}.{net.src[1]} is "
                    f"{width} bit(s) wide but its sink {s}.{p} is {w}")
            sinks.append(sink)
        if not sinks:
            continue
        nets.append((net.name, src, sinks))
    return route_nets(res, nets, max_iters=max_iters, seed=seed,
                      strategy=strategy, auto_min_tiles=auto_min_tiles)

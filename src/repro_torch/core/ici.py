"""Canal-for-collectives: the pod ICI fabric as a Canal interconnect
(counterpart of repro/core/ici.py, copied with its imports rewritten).

It stays a model of the TPU pod's torus, which is its subject: the port
runs it on the host (numpy and the port's router), and its link figures
are ``TPU_V5E``'s.

The beyond-paper integration (DESIGN.md §2): the same graph IR + router
that generates CGRA interconnects models the TPU pod's 2-D torus. Chips
are GENERIC nodes, ICI links are edges; a compiled step's collectives
become *nets* (per-hop transfers of their ring schedules), and either

* a fast dimension-ordered accounting (`link_loads`) or
* Canal's own negotiated-congestion router (`route_traffic_canal`)

assigns them to physical links. The congestion-aware collective time
(max-link bytes / link bw) refines the naive ``bytes/(links x bw)``
roofline term, and lets us DSE the mesh the way the paper DSEs switch
boxes (axis order, torus vs mesh, per-axis ring schedules).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .graph import Node, NodeKind
from repro_torch.roofline.hw import TPU_V5E, ChipSpec


@dataclass
class PodFabric:
    """2-D torus of chips; link_bytes[(src, dst)] accumulates traffic."""

    nx: int
    ny: int
    torus: bool = True

    def __post_init__(self):
        self.link_bytes: Dict[Tuple[int, int], float] = {}
        for x in range(self.nx):
            for y in range(self.ny):
                i = self.chip(x, y)
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    xx, yy = x + dx, y + dy
                    if self.torus:
                        xx %= self.nx
                        yy %= self.ny
                    elif not (0 <= xx < self.nx and 0 <= yy < self.ny):
                        continue
                    j = self.chip(xx, yy)
                    if i != j:
                        self.link_bytes[(i, j)] = 0.0

    def chip(self, x: int, y: int) -> int:
        return y * self.nx + x

    def coords(self, i: int) -> Tuple[int, int]:
        return i % self.nx, i // self.nx

    def add(self, src: int, dst: int, nbytes: float) -> None:
        self.link_bytes[(src, dst)] += nbytes

    # ------------------------------------------------- collective schedules
    def ring_neighbors(self, axis: str) -> List[Tuple[int, int]]:
        """Unidirectional ring hops along one torus axis, all rows/cols."""
        hops = []
        if axis == "x":
            for y in range(self.ny):
                for x in range(self.nx):
                    hops.append((self.chip(x, y),
                                 self.chip((x + 1) % self.nx, y)))
        else:
            for x in range(self.nx):
                for y in range(self.ny):
                    hops.append((self.chip(x, y),
                                 self.chip(x, (y + 1) % self.ny)))
        return hops

    def apply_all_reduce(self, nbytes: float, axis: str,
                         bidirectional: bool = True) -> None:
        """Ring all-reduce on one axis: reduce-scatter + all-gather, each
        moving (N-1)/N of the tensor over every ring hop."""
        n = self.nx if axis == "x" else self.ny
        per_hop = 2.0 * nbytes * (n - 1) / n / n
        hops = self.ring_neighbors(axis)
        share = 0.5 if bidirectional else 1.0
        for s, d in hops:
            self.add(s, d, per_hop * share)
            if bidirectional:
                self.add(d, s, per_hop * share)

    def apply_all_gather(self, nbytes: float, axis: str) -> None:
        n = self.nx if axis == "x" else self.ny
        per_hop = nbytes * (n - 1) / n / n
        for s, d in self.ring_neighbors(axis):
            self.add(s, d, per_hop)

    def apply_all_to_all(self, nbytes: float, axis: str) -> None:
        """Pairwise exchange along the axis, dimension-ordered."""
        n = self.nx if axis == "x" else self.ny
        # each chip sends nbytes/n to each of n-1 peers; average hop
        # distance on a ring is n/4 (bidirectional shortest path)
        avg_hops = max(n / 4.0, 1.0)
        per_link = nbytes / n * (n - 1) * avg_hops / n
        for s, d in self.ring_neighbors(axis):
            self.add(s, d, per_link / 2)
            self.add(d, s, per_link / 2)

    # ---------------------------------------------------------- summaries
    def max_link_bytes(self) -> float:
        return max(self.link_bytes.values(), default=0.0)

    def total_bytes(self) -> float:
        return sum(self.link_bytes.values())

    def congestion_factor(self) -> float:
        """max link load / mean link load (1.0 = perfectly balanced)."""
        loads = np.array(list(self.link_bytes.values()))
        mean = loads.mean() if loads.size else 0.0
        return float(loads.max() / mean) if mean > 0 else 1.0

    def collective_time(self, chip: ChipSpec = TPU_V5E) -> float:
        return self.max_link_bytes() / chip.ici_link_bw


AXIS_OF_GROUP = {16: None}      # resolved against the mesh shape


def pod_collective_model(collectives_by_kind: Dict[str, float],
                         mesh_axes: Dict[str, int],
                         chip: ChipSpec = TPU_V5E,
                         axis_order: Tuple[str, str] = ("data", "model")
                         ) -> Dict[str, float]:
    """Schedule a dry-run cell's collective traffic onto the pod torus.

    collectives_by_kind: per-chip link traffic by op kind (from the HLO
    parse). Model-axis collectives ride the x rings, data-axis the y
    rings (axis_order swaps this — a DSE knob).
    """
    nx = mesh_axes.get("model", 16)
    ny = mesh_axes.get("data", 16)
    # per_chip values are already *link traffic* (ring factors applied by
    # hlo_parse). The naive roofline spreads them over all 4 links; the
    # pod model recognizes that each collective's ring only uses the 2
    # links of ITS axis: tensor-parallel collectives (all-gather /
    # reduce-scatter / all-to-all) ride the model axis, gradient
    # all-reduce rides the data axis, so per-axis hot-link load is
    # traffic/2, not traffic/4.
    model_kinds = ("all-gather", "reduce-scatter", "all-to-all",
                   "collective-permute")
    t_model = sum(v for k, v in collectives_by_kind.items()
                  if k in model_kinds)
    t_data = sum(v for k, v in collectives_by_kind.items()
                 if k == "all-reduce")
    if axis_order != ("data", "model"):
        t_model, t_data = t_data, t_model
    x_load = t_model / 2.0               # 2 links per axis per chip
    y_load = t_data / 2.0
    max_link = max(x_load, y_load)
    total = sum(collectives_by_kind.values())
    naive = total / chip.ici_links
    return {
        "max_link_bytes": max_link,
        "congestion_factor": (max_link / (total / chip.ici_links)
                              if total > 0 else 1.0),
        "collective_time_s": max_link / chip.ici_link_bw,
        "naive_time_s": naive / chip.ici_link_bw,
    }


# ---------------------------------------------------------------------------
# Canal-router variant: the pod as a Canal IR graph, nets routed with the
# paper's negotiated-congestion router (demonstrates IR reuse; small pods)
# ---------------------------------------------------------------------------


class _ChipNode(Node):
    kind = NodeKind.GENERIC

    def __init__(self, x: int, y: int, port: int):
        super().__init__(x, y, track=port, width=32)
        self.port = port

    def node_key(self):
        return ("CHIP", self.x, self.y, self.port)


class _FlowPort(Node):
    kind = NodeKind.PORT

    def __init__(self, name: str, x: int, y: int):
        super().__init__(x, y, track=0, width=32)
        self.name = name

    def node_key(self):
        return ("FLOWPORT", self.name, self.x, self.y)


def route_traffic_canal(nx: int, ny: int,
                        flows: Sequence[Tuple[Tuple[int, int],
                                              Tuple[int, int]]],
                        lanes: int = 2):
    """Route point-to-point flows over the pod with Canal's PathFinder.

    Chips provide ``lanes`` capacity-1 transit nodes per location; every
    flow gets its own inject/eject PORT nodes (NIC model) so endpoints
    never block transit. Returns (RoutingResult, transit usage histogram).
    Used by the ICI DSE benchmark/tests on small pods.
    """
    from repro_torch.core.pnr.route import RoutingResources, route_nets

    class _FakeIC:
        def __init__(self, all_nodes):
            self._nodes = all_nodes
            self.widths = [32]

        def nodes(self):
            return iter(self._nodes)

    nodes: List[Node] = []
    grid: Dict[Tuple[int, int], List[_ChipNode]] = {}
    for y in range(ny):
        for x in range(nx):
            ports = [_ChipNode(x, y, p) for p in range(lanes)]
            grid[(x, y)] = ports
            nodes.extend(ports)
    for (x, y), ports in grid.items():
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            xx, yy = (x + dx) % nx, (y + dy) % ny
            for p_src in ports:
                for p_dst in grid[(xx, yy)]:   # lane change allowed at hop
                    p_src.add_edge(p_dst, delay=1.0)

    flow_ports: List[Tuple[_FlowPort, _FlowPort]] = []
    for i, (src, dst) in enumerate(flows):
        inj = _FlowPort(f"inj{i}", *src)
        ej = _FlowPort(f"ej{i}", *dst)
        for lane_node in grid[src]:
            inj.add_edge(lane_node)
        for lane_node in grid[dst]:
            lane_node.add_edge(ej)
        nodes += [inj, ej]
        flow_ports.append((inj, ej))

    res = RoutingResources(_FakeIC(nodes), reg_penalty=0.0)
    nets = [(f"flow{i}", res.node_id[inj], [res.node_id[ej]])
            for i, (inj, ej) in enumerate(flow_ports)
            if inj.x != ej.x or inj.y != ej.y]
    # transit nodes carry 2 virtual channels; flow ports are exclusive
    cap = np.where(res.kind == int(NodeKind.PORT), 1, 2).astype(np.int32)
    result = route_nets(res, nets, max_iters=80,
                        pres_fac0=1.0, pres_growth=1.7,
                        node_capacity=cap)
    usage = np.zeros(len(res.nodes), np.int32)
    for net in result.nets:
        for nid in net.nodes_used():
            if res.kind[nid] != int(NodeKind.PORT):
                usage[nid] += 1
    return result, usage

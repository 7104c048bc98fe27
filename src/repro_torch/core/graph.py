"""Graph-based intermediate representation for CGRA interconnects
(Canal §3.1).

The IR primitives are *nodes* — anything that can be connected in the
underlying hardware — and directed *edges* — wires connecting nodes. A node
with multiple incoming edges lowers to a configurable multiplexer; node
attributes (kind, x, y, side, track, width, delay) drive type checking,
hardware generation and PnR.

This module is pure Python data structures (no JAX): the IR must stay cheap
to build and mutate during design-space exploration. Lowering to the JAX
functional fabric lives in ``repro_torch.core.lowering``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple


class Side(enum.IntEnum):
    """Tile side. Values match the bitstream encoding order."""

    NORTH = 0
    SOUTH = 1
    EAST = 2
    WEST = 3

    def opposite(self) -> "Side":
        return _OPPOSITE[self]

    def delta(self) -> Tuple[int, int]:
        """(dx, dy) of the neighbouring tile on this side (y grows south)."""
        return _DELTA[self]


_OPPOSITE = {
    Side.NORTH: Side.SOUTH,
    Side.SOUTH: Side.NORTH,
    Side.EAST: Side.WEST,
    Side.WEST: Side.EAST,
}
_DELTA = {
    Side.NORTH: (0, -1),
    Side.SOUTH: (0, 1),
    Side.EAST: (1, 0),
    Side.WEST: (-1, 0),
}


class IO(enum.IntEnum):
    SB_IN = 0
    SB_OUT = 1


class NodeKind(enum.IntEnum):
    SWITCH_BOX = 0
    PORT = 1       # core port behind a connection box (fan-in ⇒ CB mux)
    REGISTER = 2   # pipeline register on a track
    REG_MUX = 3    # selects register output vs. combinational bypass
    GENERIC = 4    # user-defined node (low-level eDSL escape hatch)


_node_uid = 0


def _next_uid() -> int:
    global _node_uid
    _node_uid += 1
    return _node_uid


class Node:
    """A connectable point in the interconnect.

    ``fan_in`` order is semantically meaningful: it is the multiplexer input
    order, and therefore fixes the meaning of the configuration select bits.
    """

    kind: NodeKind = NodeKind.GENERIC

    __slots__ = (
        "uid", "x", "y", "track", "width", "fan_in", "fan_out",
        "edge_delay_in", "delay", "attributes",
    )

    def __init__(self, x: int, y: int, track: int, width: int,
                 delay: float = 0.0):
        self.uid = _next_uid()
        self.x = x
        self.y = y
        self.track = track
        self.width = width
        self.fan_in: List["Node"] = []
        self.fan_out: List["Node"] = []
        self.edge_delay_in: List[float] = []
        self.delay = delay            # intrinsic node delay (mux/reg), ns
        self.attributes: Dict[str, object] = {}

    # -- connectivity -------------------------------------------------------
    def add_edge(self, other: "Node", delay: float = 0.0) -> None:
        """Wire ``self -> other``. Widths must match (type check)."""
        if self.width != other.width:
            raise ValueError(
                f"width mismatch on edge {self} -> {other}: "
                f"{self.width} != {other.width}")
        if other in self.fan_out:
            return  # idempotent
        self.fan_out.append(other)
        other.fan_in.append(self)
        other.edge_delay_in.append(delay)

    def remove_edge(self, other: "Node") -> None:
        if other not in self.fan_out:
            raise ValueError(f"no edge {self} -> {other}")
        self.fan_out.remove(other)
        idx = other.fan_in.index(self)
        other.fan_in.pop(idx)
        other.edge_delay_in.pop(idx)

    def get_conn_in(self) -> List["Node"]:
        """Ordered mux inputs (the order defines select-bit semantics)."""
        return list(self.fan_in)

    # -- identity ------------------------------------------------------------
    def node_key(self) -> Tuple:
        """Stable, structural identity used for serialization & bitstreams."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}{self.node_key()}"

    def __hash__(self) -> int:
        return self.uid

    def __eq__(self, other: object) -> bool:
        return self is other


class SwitchBoxNode(Node):
    kind = NodeKind.SWITCH_BOX
    __slots__ = ("side", "io")

    def __init__(self, x: int, y: int, track: int, width: int, side: Side,
                 io: IO, delay: float = 0.0):
        super().__init__(x, y, track, width, delay)
        self.side = side
        self.io = io

    def node_key(self) -> Tuple:
        return ("SB", self.x, self.y, int(self.side), int(self.io),
                self.track, self.width)


class PortNode(Node):
    kind = NodeKind.PORT
    __slots__ = ("port_name",)

    def __init__(self, port_name: str, x: int, y: int, width: int,
                 delay: float = 0.0):
        super().__init__(x, y, 0, width, delay)
        self.port_name = port_name

    def node_key(self) -> Tuple:
        return ("PORT", self.x, self.y, self.port_name, self.width)


class RegisterNode(Node):
    kind = NodeKind.REGISTER
    __slots__ = ("reg_name",)

    def __init__(self, reg_name: str, x: int, y: int, track: int, width: int,
                 delay: float = 0.0):
        super().__init__(x, y, track, width, delay)
        self.reg_name = reg_name

    def node_key(self) -> Tuple:
        return ("REG", self.x, self.y, self.reg_name, self.track, self.width)


class RegisterMuxNode(Node):
    kind = NodeKind.REG_MUX
    __slots__ = ("mux_name",)

    def __init__(self, mux_name: str, x: int, y: int, track: int, width: int,
                 delay: float = 0.0):
        super().__init__(x, y, track, width, delay)
        self.mux_name = mux_name

    def node_key(self) -> Tuple:
        return ("RMUX", self.x, self.y, self.mux_name, self.track, self.width)


# ---------------------------------------------------------------------------
# Switch box
# ---------------------------------------------------------------------------

# An internal SB connection: (track_from, side_from, track_to, side_to).
SBConnection = Tuple[int, Side, int, Side]


class SwitchBox:
    """A tile's switch box: 4 sides × num_tracks × {in, out} nodes plus the
    internal topology edges between them."""

    def __init__(self, x: int, y: int, num_tracks: int, width: int,
                 internal_connections: Sequence[SBConnection],
                 mux_delay: float = 0.06):
        self.x = x
        self.y = y
        self.num_tracks = num_tracks
        self.width = width
        self.internal_connections: List[SBConnection] = []
        # sbs[side][io][track]
        self.sbs: Dict[Side, Dict[IO, List[SwitchBoxNode]]] = {}
        for side in Side:
            self.sbs[side] = {}
            for io in IO:
                self.sbs[side][io] = [
                    SwitchBoxNode(x, y, t, width, side, io,
                                  delay=mux_delay if io == IO.SB_OUT else 0.0)
                    for t in range(num_tracks)
                ]
        self.add_internal_connections(internal_connections)

    def add_internal_connections(
            self, connections: Sequence[SBConnection]) -> None:
        """Wire internal topology edges (in -> out). Split out of the
        constructor so the pass pipeline can materialize bare switch boxes
        first (``materialize_tiles``) and apply the topology as its own
        pass (``apply_sb_topology``)."""
        connections = list(connections)   # survive one-shot iterators
        for (t_from, s_from, t_to, s_to) in connections:
            src = self.get_sb(s_from, t_from, IO.SB_IN)
            dst = self.get_sb(s_to, t_to, IO.SB_OUT)
            src.add_edge(dst)
        self.internal_connections.extend(connections)

    def get_sb(self, side: Side, track: int, io: IO) -> SwitchBoxNode:
        return self.sbs[side][io][track]

    def nodes(self) -> Iterator[SwitchBoxNode]:
        for side in Side:
            for io in IO:
                yield from self.sbs[side][io]

    def remove_side_connections(self, side: Side, io: IO) -> None:
        """Depopulate one side (used by the port-connection DSE, Fig. 12)."""
        for node in self.sbs[side][io]:
            for other in list(node.fan_out):
                node.remove_edge(other)
            for src in list(node.fan_in):
                src.remove_edge(node)


# ---------------------------------------------------------------------------
# Tiles & cores
# ---------------------------------------------------------------------------


@dataclass
class PortSpec:
    name: str
    width: int
    is_input: bool
    delay: float = 0.0


class Core:
    """A compute/memory core dropped into a tile. Pure port bundle at the IR
    level; the functional behaviour is attached at lowering time."""

    core_type = "core"
    #: combinational delay through the core, ns (used by STA)
    delay: float = 0.8

    def __init__(self, ports: Sequence[PortSpec]):
        self.ports = list(ports)

    def inputs(self) -> List[PortSpec]:
        return [p for p in self.ports if p.is_input]

    def outputs(self) -> List[PortSpec]:
        return [p for p in self.ports if not p.is_input]


class Tile:
    """One interconnect tile: a switch box, connection boxes (port nodes) and
    an optional core."""

    def __init__(self, x: int, y: int, switchbox: SwitchBox,
                 core: Optional[Core] = None):
        self.x = x
        self.y = y
        self.switchbox = switchbox
        self.core = core
        self.ports: Dict[str, PortNode] = {}
        if core is not None:
            for p in core.ports:
                self.ports[p.name] = PortNode(p.name, x, y, p.width,
                                              delay=p.delay)

    @property
    def core_type(self) -> str:
        return self.core.core_type if self.core is not None else "empty"

    def get_port(self, name: str) -> PortNode:
        return self.ports[name]

    def nodes(self) -> Iterator[Node]:
        yield from self.switchbox.nodes()
        yield from self.ports.values()


class InterconnectGraph:
    """The IR for one routing bit-width: a grid of tiles plus registers."""

    def __init__(self, width: int):
        self.width = width               # data bit width of this layer
        self.tiles: Dict[Tuple[int, int], Tile] = {}
        self.registers: List[RegisterNode] = []
        self.reg_muxes: List[RegisterMuxNode] = []
        #: nodes removed by ``prune`` — excluded from ``nodes()`` (and so
        #: from lowering, routing, area and connectivity)
        self._pruned: set = set()

    # -- construction --------------------------------------------------------
    def add_tile(self, tile: Tile) -> None:
        self.tiles[(tile.x, tile.y)] = tile

    def get_tile(self, x: int, y: int) -> Optional[Tile]:
        return self.tiles.get((x, y))

    def get_sb(self, x: int, y: int, side: Side, track: int,
               io: IO) -> Optional[SwitchBoxNode]:
        tile = self.get_tile(x, y)
        if tile is None:
            return None
        if track >= tile.switchbox.num_tracks:
            return None
        return tile.switchbox.get_sb(side, track, io)

    def get_port(self, x: int, y: int, name: str) -> PortNode:
        return self.tiles[(x, y)].get_port(name)

    def add_register(self, reg: RegisterNode) -> None:
        self.registers.append(reg)

    def add_reg_mux(self, mux: RegisterMuxNode) -> None:
        self.reg_muxes.append(mux)

    def prune(self, nodes: Iterable[Node]) -> None:
        """Remove observer-free nodes (no fan-out) from the graph's node
        set, detaching their incoming edges. A node with fan-out cannot
        be pruned: removing it would shrink its consumers' fan-in lists,
        renumbering surviving mux inputs and silently changing config
        semantics. Detaching *incoming* edges is safe — it only shrinks
        the drivers' fan-out lists, which carry no select-bit meaning
        (and may expose those drivers as newly observer-free: callers
        such as ``prune_dead_muxes`` iterate to a fixpoint)."""
        nodes = list(nodes)       # a generator must not drain on validation
        for n in nodes:
            if n.fan_out:
                raise ValueError(
                    f"cannot prune node still connected downstream: {n}")
        dead = set(nodes)
        if not dead:
            return
        for n in dead:
            for src in list(n.fan_in):
                src.remove_edge(n)
        self.registers = [r for r in self.registers if r not in dead]
        self.reg_muxes = [m for m in self.reg_muxes if m not in dead]
        self._pruned.update(dead)

    # -- queries --------------------------------------------------------------
    def nodes(self) -> Iterator[Node]:
        if self._pruned:
            for tile in self.tiles.values():
                for n in tile.nodes():
                    if n not in self._pruned:
                        yield n
        else:
            for tile in self.tiles.values():
                yield from tile.nodes()
        yield from self.registers
        yield from self.reg_muxes

    def num_nodes(self) -> int:
        return sum(1 for _ in self.nodes())

    def edges(self) -> Iterator[Tuple[Node, Node, float]]:
        for node in self.nodes():
            for dst, d in zip(node.fan_out,
                              _delays_for(node)):
                yield node, dst, d

    def dims(self) -> Tuple[int, int]:
        xs = [x for x, _ in self.tiles]
        ys = [y for _, y in self.tiles]
        return max(xs) + 1, max(ys) + 1

    # -- structural serialization (used for verification round-trips) --------
    def connectivity(self) -> Dict[Tuple, List[Tuple]]:
        """Structural map node_key -> sorted fan-in node_keys."""
        out: Dict[Tuple, List[Tuple]] = {}
        for node in self.nodes():
            out[node.node_key()] = [n.node_key() for n in node.fan_in]
        return out


def _delays_for(node: Node) -> List[float]:
    """Edge delays, aligned with node.fan_out (looked up on the dst side)."""
    ds = []
    for dst in node.fan_out:
        idx = dst.fan_in.index(node)
        ds.append(dst.edge_delay_in[idx])
    return ds


class Interconnect:
    """Top level: one InterconnectGraph per routing bit-width, plus global
    metadata. This is what the eDSL emits and every backend consumes."""

    def __init__(self, graphs: Dict[int, InterconnectGraph],
                 config_addr_width: int = 8, config_data_width: int = 32):
        self.graphs = graphs
        self.config_addr_width = config_addr_width
        self.config_data_width = config_data_width
        self.params: Dict[str, object] = {}

    def graph(self, width: int) -> InterconnectGraph:
        return self.graphs[width]

    @property
    def widths(self) -> List[int]:
        return sorted(self.graphs)

    def dims(self) -> Tuple[int, int]:
        return next(iter(self.graphs.values())).dims()

    def nodes(self) -> Iterator[Node]:
        for g in self.graphs.values():
            yield from g.nodes()

    def num_nodes(self) -> int:
        return sum(g.num_nodes() for g in self.graphs.values())

    def num_edges(self) -> int:
        return sum(sum(1 for _ in g.edges()) for g in self.graphs.values())

    def connectivity(self) -> Dict[Tuple, List[Tuple]]:
        out: Dict[Tuple, List[Tuple]] = {}
        for g in self.graphs.values():
            out.update(g.connectivity())
        return out


# ---------------------------------------------------------------------------
# Topological utilities shared by lowering & PnR
# ---------------------------------------------------------------------------


def levelize(nodes: Iterable[Node]) -> List[List[Node]]:
    """Group nodes into combinational levels. REGISTER nodes are sequential
    boundaries: their outputs are level-0 sources (state), so cycles through
    registers are legal; a purely combinational cycle raises."""
    nodes = list(nodes)
    level: Dict[Node, int] = {}
    indeg: Dict[Node, int] = {}
    for n in nodes:
        if n.kind == NodeKind.REGISTER:
            indeg[n] = 0        # state: breaks the cycle
        else:
            indeg[n] = len(n.fan_in)
    frontier = [n for n in nodes if indeg[n] == 0]
    for n in frontier:
        level[n] = 0
    seen = 0
    order: List[Node] = []
    while frontier:
        n = frontier.pop()
        order.append(n)
        seen += 1
        for dst in n.fan_out:
            if dst.kind == NodeKind.REGISTER:
                continue
            indeg[dst] -= 1
            level[dst] = max(level.get(dst, 0), level[n] + 1)
            if indeg[dst] == 0:
                frontier.append(dst)
    if seen != len(nodes):
        stuck = [n for n in nodes if n not in level]
        raise ValueError(
            f"combinational cycle through {len(stuck)} nodes, e.g. "
            f"{stuck[:4]}")
    # registers live at level 0 (as sources); also appear as sinks implicitly
    n_levels = max(level.values()) + 1 if level else 0
    buckets: List[List[Node]] = [[] for _ in range(n_levels)]
    for n in order:
        buckets[level[n]].append(n)
    return buckets

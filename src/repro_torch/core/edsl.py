"""The Canal eDSL (§3.2): Python helpers that build the interconnect IR.

Two levels, as in the paper:

* low level — instantiate ``Node`` subclasses and ``add_edge`` them together
  (Fig. 4 top);
* high level — a declarative :class:`repro_torch.core.spec.InterconnectSpec`
  compiled through the pass pipeline (:mod:`repro_torch.core.passes`) via
  ``canal_torch.compile`` / ``PassManager.compile``.

This module keeps the switch-box topology generators (the reusable
"connection pattern" half of the eDSL) and the low-level node helpers.
The old monolithic generator ``create_uniform_interconnect(...)`` (Fig. 4
bottom) survives as a thin **deprecated** shim that builds a spec and runs
the exact same pass pipeline — it produces IR isomorphic to
``PassManager().run(InterconnectSpec(...))`` by construction.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Sequence

from .graph import IO, Interconnect, Node, SBConnection, Side, SwitchBoxNode
from .spec import InterconnectSpec, SwitchBoxType
from .tiles import Core


# ---------------------------------------------------------------------------
# Switch-box topologies (§4.2.1, Fig. 9)
# ---------------------------------------------------------------------------

def disjoint_connections(num_tracks: int) -> List[SBConnection]:
    """Track i connects only to track i on the other three sides."""
    conns: List[SBConnection] = []
    for t in range(num_tracks):
        for s_from in Side:
            for s_to in Side:
                if s_from == s_to:
                    continue
                conns.append((t, s_from, t, s_to))
    return conns


def wilton_connections(num_tracks: int) -> List[SBConnection]:
    """Classic Wilton switch block: straight tracks pass through, turns are
    track permutations — same mux sizes as disjoint (each input reaches each
    other side exactly once) but far better routability."""
    w = num_tracks
    conns: List[SBConnection] = []
    for t in range(w):
        # straight through
        conns.append((t, Side.WEST, t, Side.EAST))
        conns.append((t, Side.EAST, t, Side.WEST))
        conns.append((t, Side.NORTH, t, Side.SOUTH))
        conns.append((t, Side.SOUTH, t, Side.NORTH))
        # turns (Wilton permutations)
        conns.append((t, Side.WEST, (w - t) % w, Side.NORTH))
        conns.append(((w - t) % w, Side.NORTH, t, Side.WEST))
        conns.append((t, Side.NORTH, (t + 1) % w, Side.EAST))
        conns.append(((t + 1) % w, Side.EAST, t, Side.NORTH))
        conns.append((t, Side.EAST, (2 * w - 2 - t) % w, Side.SOUTH))
        conns.append(((2 * w - 2 - t) % w, Side.SOUTH, t, Side.EAST))
        conns.append((t, Side.SOUTH, (t + 1) % w, Side.WEST))
        conns.append(((t + 1) % w, Side.WEST, t, Side.SOUTH))
    return conns


def imran_connections(num_tracks: int) -> List[SBConnection]:
    """Imran-style universal block: straight passes plus reflected turns."""
    w = num_tracks
    conns: List[SBConnection] = []
    for t in range(w):
        conns.append((t, Side.WEST, t, Side.EAST))
        conns.append((t, Side.EAST, t, Side.WEST))
        conns.append((t, Side.NORTH, t, Side.SOUTH))
        conns.append((t, Side.SOUTH, t, Side.NORTH))
        conns.append((t, Side.WEST, (w - 1 - t) % w, Side.NORTH))
        conns.append(((w - 1 - t) % w, Side.NORTH, t, Side.WEST))
        conns.append((t, Side.NORTH, (t + 1) % w, Side.EAST))
        conns.append(((t + 1) % w, Side.EAST, t, Side.NORTH))
        conns.append((t, Side.EAST, (w - 1 - t) % w, Side.SOUTH))
        conns.append(((w - 1 - t) % w, Side.SOUTH, t, Side.EAST))
        conns.append((t, Side.SOUTH, (t + 1) % w, Side.WEST))
        conns.append(((t + 1) % w, Side.WEST, t, Side.SOUTH))
    return conns


SB_TOPOLOGIES: Dict[SwitchBoxType, Callable[[int], List[SBConnection]]] = {
    SwitchBoxType.DISJOINT: disjoint_connections,
    SwitchBoxType.WILTON: wilton_connections,
    SwitchBoxType.IMRAN: imran_connections,
}


# ---------------------------------------------------------------------------
# Deprecated high-level generator (now a shim over the pass pipeline)
# ---------------------------------------------------------------------------

def create_uniform_interconnect(
        width: int = 8,
        height: int = 8,
        sb_type: "SwitchBoxType | str" = SwitchBoxType.WILTON,
        num_tracks: int = 5,
        track_width: int = 16,
        reg_density: float = 1.0,
        core_fn: Optional[Callable[[int, int, int, int], Optional[Core]]]
        = None,
        spec: Optional[InterconnectSpec] = None,
        **kwargs) -> Interconnect:
    """Create a uniform interconnect (all SBs share one topology, no diagonal
    connections). Mirrors the paper's helper (Fig. 4, bottom).

    .. deprecated::
        Use the front door instead:
        ``canal_torch.compile(InterconnectSpec(...))`` (or
        ``PassManager().run(spec)`` for the bare IR). This shim builds the
        same spec and runs the same pass pipeline, so the result is
        isomorphic; it only exists so existing call sites keep working.
    """
    warnings.warn(
        "create_uniform_interconnect is deprecated; use "
        "canal_torch.compile(InterconnectSpec(...)) — the pass-pipeline "
        "front door — instead", DeprecationWarning, stacklevel=2)
    from .passes import PassManager
    if spec is None:
        spec = InterconnectSpec(width=width, height=height, sb_type=sb_type,
                                num_tracks=num_tracks,
                                track_width=track_width,
                                reg_density=reg_density, **kwargs)
    return PassManager().run(spec, core_fn=core_fn)


# ---------------------------------------------------------------------------
# Low-level helpers (paper Fig. 4, top)
# ---------------------------------------------------------------------------

def make_sb_node(x: int, y: int, side: "Side | str", track: int,
                 width: int = 16, io: IO = IO.SB_OUT) -> SwitchBoxNode:
    if isinstance(side, str):
        side = Side[side.upper()]
    return SwitchBoxNode(x, y, track, width, side, io)


def connect_all(node: Node, targets: Sequence[Node], delay: float = 0.0
                ) -> None:
    for t in targets:
        node.add_edge(t, delay=delay)

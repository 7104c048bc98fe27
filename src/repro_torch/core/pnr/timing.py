"""Static timing analysis over a routed application (§3.4, Fig. 7).

The IR's edge weights carry wire/mux delays; cores carry intrinsic delays.
Registers (and register-mode FIFOs) cut timing paths. The application's
achievable clock period is the longest register-to-register (or IO-to-IO)
combinational path: interconnect segments from the routed nets plus core
traversal delays. Application *run time* = critical path × cycle count, the
metric behind Figs. 11/14/15.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


from repro_torch.core.graph import NodeKind
from .packing import PackedGraph
from .route import RoutingResult, RoutingResources


def _net_segment_delays(res: RoutingResources, tree: Dict[int, int],
                        src: int, sinks: Sequence[int]
                        ) -> Dict[int, Tuple[float, int]]:
    """For each sink: (combinational delay of the longest register-free
    suffix reaching it, number of registers crossed on its path)."""
    out: Dict[int, Tuple[float, int]] = {}
    for sink in sinks:
        path = [sink]
        node = sink
        while node != src and node in tree:
            node = tree[node]
            path.append(node)
        path.reverse()
        d = res.nodes[path[0]].delay
        regs = 0
        for a, b in zip(path, path[1:]):
            nb = res.nodes[b]
            if nb.kind == NodeKind.REGISTER:
                regs += 1
                d = 0.0                      # path cut
            d += nb.delay + res.edge_delay_map[(a, b)]
        out[sink] = (d, regs)
    return out


def _sink_arrivals(packed: PackedGraph, result: RoutingResult,
                   core_delay: float = 0.8,
                   split_fifo_ctrl_delay: float = 0.0
                   ) -> List[Tuple[str, str, int, float]]:
    """Per-sink arrival times of every routed net, via the same
    relaxation :func:`sta_critical_path` gates on: entries are
    ``(net_name, sink_instance, sink_node_id, arrival_ns)`` where
    arrival is the combinational path delay into that sink (register
    stages cut the path; split-FIFO control chains add back)."""
    res = result.resources
    # arrival time at each instance output = max over input nets of
    # (arrival at net source + net comb delay) + core delay; registers in
    # the app (packed into PEs) cut paths. Iterate in topological-ish order
    # with relaxation (app graphs are small).
    inst_arrival: Dict[str, float] = {}
    net_by_name = {n.name: n for n in result.nets}
    app_nets = [n for n in packed.nets if n.name in net_by_name]

    arrivals: Dict[Tuple[str, str, int], float] = {}
    for _ in range(len(packed.placeable) + 2):
        changed = False
        for net in app_nets:
            rnet = net_by_name[net.name]
            src_arr = inst_arrival.get(net.src[0], 0.0)
            seg = _net_segment_delays(res, rnet.tree, rnet.src, rnet.sinks)
            for (sink_inst, _), sink_id in zip(net.sinks, rnet.sinks):
                d, regs = seg[sink_id]
                ctrl = regs * split_fifo_ctrl_delay
                arr_in = (src_arr if regs == 0 else 0.0) + d + ctrl
                arrivals[(net.name, sink_inst, sink_id)] = arr_in
                kind = packed.placeable.get(sink_inst)
                cd = core_delay if (kind and kind.kind == "pe") else 0.1
                a = arr_in + cd
                if a > inst_arrival.get(sink_inst, 0.0) + 1e-12:
                    inst_arrival[sink_inst] = a
                    changed = True
        if not changed:
            break
    return [(name, inst, nid, arr)
            for (name, inst, nid), arr in arrivals.items()]


def sta_critical_path(packed: PackedGraph, result: RoutingResult,
                      placement: Dict[str, Tuple[int, int]],
                      core_delay: float = 0.8,
                      split_fifo_ctrl_delay: float = 0.0
                      ) -> Dict[str, float]:
    """Longest combinational path through routed nets + cores.

    split_fifo_ctrl_delay models the paper's split-FIFO drawback: the FIFO
    control signals are not registered at tile boundaries, so chained
    control adds combinational delay proportional to registers crossed.

    Returns {"critical_path_ns", "max_net_delay_ns", "total_wirelength"}.
    """
    arrivals = _sink_arrivals(packed, result, core_delay,
                              split_fifo_ctrl_delay)
    crit = max((arr for _, _, _, arr in arrivals), default=0.0)
    max_net = max((n.delay for n in result.nets), default=0.0)
    return {
        "critical_path_ns": max(crit, max_net),
        "max_net_delay_ns": max_net,
        "total_wirelength": float(result.total_wirelength()),
    }


def sta_net_slacks(packed: PackedGraph, result: RoutingResult,
                   placement: Dict[str, Tuple[int, int]],
                   clock_ns: Optional[float] = None,
                   core_delay: float = 0.8,
                   split_fifo_ctrl_delay: float = 0.0,
                   bins: int = 8) -> Dict:
    """Full per-net slack table extending :func:`sta_critical_path`.

    Each routed net sink gets ``slack = period - arrival`` where the
    period is ``clock_ns`` when given, else the achieved critical path
    (so slack is the headroom to the design's own worst path). Returns::

        {"period_ns", "critical_path_ns", "min_slack_ns",
         "nets": [{"net", "sink", "arrival_ns", "slack_ns"}, ...],
         "histogram": [{"lo", "hi", "count"}, ...]}

    ``nets`` is sorted most-critical first; the histogram spans
    [min_slack, period] in ``bins`` equal buckets — the shape the
    ``sta-slack`` rule and the lint JSON artifact report."""
    arrivals = _sink_arrivals(packed, result, core_delay,
                              split_fifo_ctrl_delay)
    crit = max((arr for _, _, _, arr in arrivals), default=0.0)
    max_net = max((n.delay for n in result.nets), default=0.0)
    crit = max(crit, max_net)
    period = float(clock_ns) if clock_ns is not None else crit
    rows = sorted(({"net": name, "sink": inst,
                    "arrival_ns": arr, "slack_ns": period - arr}
                   for name, inst, _, arr in arrivals),
                  key=lambda r: (r["slack_ns"], r["net"], r["sink"]))
    min_slack = rows[0]["slack_ns"] if rows else period
    hist: List[Dict] = []
    if rows and bins > 0:
        lo, hi = min(min_slack, 0.0), max(period, min_slack)
        width = (hi - lo) / bins or 1.0
        counts = [0] * bins
        for r in rows:
            i = min(int((r["slack_ns"] - lo) / width), bins - 1)
            counts[max(i, 0)] += 1
        hist = [{"lo": lo + i * width, "hi": lo + (i + 1) * width,
                 "count": c} for i, c in enumerate(counts)]
    return {"period_ns": period, "critical_path_ns": crit,
            "min_slack_ns": min_slack, "nets": rows, "histogram": hist}

"""End-to-end PnR driver (§3.4): pack → global place → legalize →
anneal → route → STA → bitstream, with the paper's α sweep ("sweeping
α from 1 to 20 and choosing the best result post-routing").
(Counterpart of repro/core/pnr/driver.py.)"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


from repro_torch.core.graph import Interconnect, Node
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import span
from .app import AppGraph
from .packing import PackedGraph, pack
from .global_place import assign_ios, global_place, legalize
from .detailed_place import detailed_place, resolve_place_strategy
from .route import (RoutingError, RoutingResources, RoutingResult, route_app)
from .timing import sta_critical_path


@dataclass
class PnRResult:
    success: bool
    placement: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    #: the packed netlist the flow placed/routed (emulation binds to it)
    packed: Optional[PackedGraph] = None
    routing: Optional[RoutingResult] = None
    timing: Dict[str, float] = field(default_factory=dict)
    alpha: float = 1.0
    wirelength: int = 0
    route_iterations: int = 0
    seconds: float = 0.0
    error: str = ""
    #: router engine that produced the winning route ("python"/"minplus");
    #: with strategy "auto" this records the resolved pick per point
    route_strategy: str = ""
    #: placement engine that annealed the winning placement
    #: ("python" host SA / "batched" device chains); "auto" resolves
    #: once per point and the pick is recorded here
    place_strategy: str = ""
    #: routed-scope :class:`repro_torch.core.analysis.AnalysisReport`, attached
    #: by ``CompiledFabric.place_and_route`` (None when run standalone)
    analysis: Optional[object] = None

    def route_edges(self) -> List[Tuple[Node, Node]]:
        assert self.routing is not None
        return self.routing.all_edges_nodes()


def place_and_route(ic: Interconnect, app: AppGraph,
                    alphas: Sequence[float] = (1.0, 2.0, 4.0),
                    gamma: float = 0.3,
                    sa_steps: int = 200, sa_batch: int = 32,
                    route_iters: int = 40,
                    split_fifo_ctrl_delay: float = 0.0,
                    seed: int = 0,
                    resources: Optional[RoutingResources] = None,
                    route_strategy: str = "python",
                    auto_min_tiles: Optional[int] = None,
                    place_strategy: str = "python",
                    device: DeviceLike = None) -> PnRResult:
    """Run the full three-stage PnR flow, sweeping α and keeping the best
    post-route critical path (paper §3.4).

    ``route_strategy`` selects the router engine (see
    ``repro_torch.core.pnr.route``): ``"python"`` A* oracle, ``"minplus"``
    device-batched coarse lower bounds, or ``"auto"`` (tile-count switch,
    threshold overridable via ``auto_min_tiles`` /
    ``CANAL_AUTO_MIN_TILES``; the resolved engine is recorded on
    ``PnRResult.route_strategy``).

    ``place_strategy`` selects the annealing-placement engine (see
    ``repro_torch.core.pnr.detailed_place``): ``"python"`` host SA oracle,
    ``"batched"`` device-resident parallel-tempering chains
    (``sa_batch`` chains x ``sa_steps`` steps), or ``"auto"``
    (tile-count switch at ``CANAL_PLACE_AUTO_MIN_TILES``; the resolved
    engine is recorded on ``PnRResult.place_strategy``).

    The device stages (global-place CG, annealing costs, minplus fields
    of fresh ``resources``) run on ``device`` (``None``: the CUDA card)."""
    with span("pnr.app") as app_span:
        dev = resolve_device(device)
        W = int(ic.params.get("width", ic.dims()[0]))
        H = int(ic.params.get("height", ic.dims()[1]))
        mem_cols = tuple(getattr(ic, "spec", None).mem_columns
                         if getattr(ic, "spec", None) else ())
        io_ring = bool(getattr(ic, "spec", None).io_ring
                       if getattr(ic, "spec", None) else True)

        with span("pnr.pack"):
            packed = pack(app)
        with span("pnr.global_place"):
            fixed = assign_ios(packed, W, H)
            cont = global_place(packed, W, H, mem_columns=mem_cols,
                                fixed=fixed, seed=seed, device=dev)
            base_pl = legalize(packed, cont, W, H, mem_columns=mem_cols,
                               io_ring=io_ring, fixed=fixed)
        if resources is None:
            resources = RoutingResources(ic, device=dev)

        # resolve "auto" once per point so every alpha uses (and the result
        # records) one engine
        place_strat = resolve_place_strategy(W * H, place_strategy)

        best: Optional[PnRResult] = None
        last_err = ""
        for alpha in alphas:
            with span("pnr.detailed_place", alpha=alpha):
                pl = detailed_place(packed, base_pl, W, H,
                                    mem_columns=mem_cols, io_ring=io_ring,
                                    gamma=gamma, alpha=alpha,
                                    n_steps=sa_steps, batch=sa_batch,
                                    seed=seed, strategy=place_strat,
                                    device=dev)
            try:
                with span("pnr.route", alpha=alpha) as route_span:
                    routing = route_app(ic, packed, pl, max_iters=route_iters,
                                        res=resources, seed=seed,
                                        strategy=route_strategy,
                                        auto_min_tiles=auto_min_tiles)
                    route_span.attrs["nets_1b"] = sum(
                        resources.nodes[net.src].width == 1
                        for net in routing.nets)
            except RoutingError as e:
                last_err = str(e)
                continue
            with span("pnr.sta", alpha=alpha):
                timing = sta_critical_path(
                    packed, routing, pl,
                    split_fifo_ctrl_delay=split_fifo_ctrl_delay)
            cand = PnRResult(
                success=True, placement=pl, packed=packed, routing=routing,
                timing=timing, alpha=alpha,
                wirelength=routing.total_wirelength(),
                route_iterations=routing.iterations,
                route_strategy=routing.strategy,
                place_strategy=place_strat)
            if best is None or (cand.timing["critical_path_ns"]
                                < best.timing["critical_path_ns"]):
                best = cand

        if best is None:
            best = PnRResult(success=False, packed=packed,
                             error=last_err or "unroutable")
    # one clock: the result states its own span's duration
    best.seconds = app_span.seconds
    return best

"""The compiled-design handle behind ``canal_torch.compile``.

``compile_spec(InterconnectSpec(...))`` (re-exported as
``canal_torch.compile``) runs the pass pipeline and returns a
:class:`CompiledFabric`: one object that owns the IR plus lazily-built,
memoized backends —
``place_and_route(app)``, ``emulate(...)``, ``area()``,
``bitstream(cfg)``. Spec route knobs (``route_strategy``,
``auto_min_tiles``) flow through automatically, and ``spec.digest()`` /
``ir_digest()`` give the content addresses used for spec-keyed caching.
(Counterpart of repro/core/compile.py; the handle carries the device its
backends run on, and ``use_kernels`` mirrors ``use_pallas``.)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

from .graph import Interconnect, Node
from .spec import InterconnectSpec

Coord = Tuple[int, int]


class CompiledFabric:
    """A compiled interconnect design point.

    Construction goes through
    :meth:`repro_torch.core.passes.PassManager.compile` (or the
    ``canal_torch.compile`` / :func:`compile_spec` front door) — the
    constructor only binds the already-compiled IR. Every backend runs on
    ``device`` (``None``: the CUDA card).
    """

    def __init__(self, spec: InterconnectSpec, ic: Interconnect,
                 pass_log: Optional[List[Dict]] = None,
                 device: DeviceLike = None, use_kernels: bool = False,
                 cacheable: bool = True, diagnostics=None):
        self.spec = spec
        self._ic = ic
        self.pass_log = list(pass_log or [])
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        #: False when a custom (non-serializable) core_fn was injected:
        #: the spec digest then under-describes the design, so
        #: digest-keyed caches must not admit this fabric
        self.cacheable = cacheable
        #: the static-analysis AnalysisReport produced at compile time
        #: (None when compiled with analyze="off" or constructed raw)
        self.diagnostics = diagnostics
        self._fabrics: Dict[bool, object] = {}
        self._resources: Dict[float, object] = {}
        self._codec = None

    # ------------------------------------------------------------- identity
    @property
    def interconnect(self) -> Interconnect:
        return self._ic

    def digest(self) -> str:
        """The design point's content address (= ``spec.digest()``)."""
        return self.spec.digest()

    def ir_digest(self) -> str:
        """Content hash of the compiled IR (see ``passes.ir_digest``)."""
        from .passes import ir_digest
        return ir_digest(self._ic)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        s = self.spec
        return (f"CompiledFabric({s.width}x{s.height}, "
                f"{s.num_tracks}x{s.track_width}b {s.sb_type.value}, "
                f"digest={self.digest()[:12]})")

    # ------------------------------------------------------------- backends
    def fabric(self, use_kernels: Optional[bool] = None):
        """The lowered functional model: :class:`FabricModule` for the
        static interconnect, :class:`repro_torch.fabric.RVFabric` when the
        spec requests the hybrid ready-valid interconnect. Memoized per
        engine."""
        uk = self.use_kernels if use_kernels is None else use_kernels
        fab = self._fabrics.get(uk)
        if fab is None:
            if self.spec.ready_valid:
                from repro_torch.fabric import RVFabric
                # the readyvalid_transform pass annotated the IR; the
                # lowering consumes that annotation, not the raw spec
                mode = self._ic.params["rv_fifo_mode"]
                fab = RVFabric(self._ic, fifo_mode=mode, device=self.device,
                               use_kernels=uk)
            else:
                from .lowering import FabricModule
                fab = FabricModule(self._ic, device=self.device,
                                   use_kernels=uk)
            self._fabrics[uk] = fab
        return fab

    def resources(self, reg_penalty: float = 4.0):
        """Shared :class:`RoutingResources` (adjacency, base costs,
        coarse graph), memoized per ``reg_penalty``."""
        from .pnr.route import RoutingResources
        key = float(reg_penalty)
        res = self._resources.get(key)
        if res is None:
            res = RoutingResources(self._ic, reg_penalty=reg_penalty,
                                   device=self.device)
            self._resources[key] = res
        return res

    # ------------------------------------------------------------- analysis
    def analyze(self, rules: Optional[Sequence[str]] = None,
                fail_on: Optional[str] = None,
                scope: str = "ir",
                pnr=None,
                clock_ns: Optional[float] = None,
                severities: Optional[Dict[str, object]] = None):
        """(Re-)run the static analyzer on this design point and return
        the :class:`AnalysisReport` — for subsets or severities beyond
        what the compile-time ``analyze=`` knob recorded in
        :attr:`diagnostics`, or for other scopes: pass
        ``scope="routed"`` with a ``pnr=`` :class:`PnRResult` to audit a
        configured design (deadlock / throughput / slack / congestion /
        X-propagation; add ``clock_ns=`` for a slack target)."""
        from .analysis import analyze as run_rules
        return run_rules(self._ic, spec=self.spec, rules=rules,
                         scope=scope, pnr=pnr, clock_ns=clock_ns,
                         severities=severities, fail_on=fail_on)

    def verify(self, rules: Optional[Sequence[str]] = None,
               fail_on: Optional[str] = "error",
               use_kernels: Optional[bool] = None):
        """Run the post-lowering verification analyses (the paper's §3.3
        checks, registered as ``scope="lowered"`` rules:
        ``structural-equivalence`` and the exhaustive ``config-sweep``)
        against this fabric's lowered module, on this handle's device
        (the sweep through ``fabric_sweep_batch`` with ``use_kernels``).
        Costs device time — deliberately not part of compile-time
        analysis. Raises :class:`AnalysisError` at ``fail_on`` severity
        (pass ``None`` to only report); returns the
        :class:`AnalysisReport`."""
        from .analysis import analyze as run_rules
        if self.spec.ready_valid:
            raise NotImplementedError(
                "lowered verification covers the static interconnect; "
                "the ready-valid fabric has its own emulation tests")
        return run_rules(self._ic, spec=self.spec, rules=rules,
                         scope="lowered", fabric=self.fabric(use_kernels),
                         fail_on=fail_on)

    # ------------------------------------------------------------------ PnR
    def place_and_route(self, app,
                        alphas: Optional[Sequence[float]] = None,
                        sa_steps: Optional[int] = None,
                        sa_batch: Optional[int] = None,
                        seed: Optional[int] = None,
                        reg_penalty: Optional[float] = None,
                        route_strategy: Optional[str] = None,
                        place_strategy: Optional[str] = None,
                        **kwargs):
        """Pack, place and route ``app`` on this fabric (paper §3.4).

        Every PnR knob resolves spec-first: a per-call argument wins,
        then the spec's folded knob (``spec.alphas``, ``spec.sa_steps``,
        ...), then the historical front-door default — so a fully-pinned
        spec (one whose ``digest()`` addresses the result store) routes
        identically here and in the DSE executor.

        On success the routed-scope analysis report is attached as
        ``result.analysis`` (``analyze(scope="routed", ...)`` re-runs it
        with a clock target or custom severities)."""
        from .pnr import place_and_route as pnr
        s = self.spec

        def pick(call_value, spec_value, default):
            if call_value is not None:
                return call_value
            return spec_value if spec_value is not None else default

        strategy = (route_strategy or s.route_strategy or "auto")
        p_strat = (place_strategy or s.place_strategy or "auto")
        if (kwargs.get("split_fifo_ctrl_delay") is None
                and s.split_fifo_ctrl_delay is not None):
            kwargs["split_fifo_ctrl_delay"] = s.split_fifo_ctrl_delay
        result = pnr(self._ic, app,
                     alphas=pick(alphas, s.alphas, (1.0, 2.0, 4.0)),
                     sa_steps=pick(sa_steps, s.sa_steps, 200),
                     sa_batch=pick(sa_batch, s.sa_batch, 32),
                     seed=pick(seed, s.seed, 0),
                     resources=self.resources(
                         pick(reg_penalty, s.reg_penalty, 4.0)),
                     route_strategy=strategy,
                     auto_min_tiles=s.auto_min_tiles,
                     place_strategy=p_strat, device=self.device, **kwargs)
        if result.success:
            result.analysis = self.analyze(scope="routed", pnr=result)
        return result

    # ------------------------------------------------------------ emulation
    def emulate(self, result, inputs: Dict[Union[str, Coord], np.ndarray],
                cycles: int,
                use_kernels: Optional[bool] = None) -> Dict[Coord,
                                                            np.ndarray]:
        """Emulate a routed application for ``cycles`` fabric clocks.

        ``result`` is the :class:`PnRResult` from
        :meth:`place_and_route`; ``inputs`` maps IO tiles — by ``(x, y)``
        coordinate or by app instance name — to driven value streams.
        Returns observed output streams keyed by IO tile coordinate."""
        from repro_torch.fabric import AppEmulator

        if not result.success:
            raise ValueError(f"cannot emulate failed PnR: {result.error}")
        fab = self.fabric(use_kernels)
        emu = AppEmulator.from_pnr(fab, result.packed, result)
        ins: Dict[Coord, np.ndarray] = {}
        for k, v in inputs.items():
            coord = result.placement[k] if isinstance(k, str) else k
            ins[coord] = np.asarray(v, dtype=np.int32)
        return emu.run(ins, cycles)

    # ----------------------------------------------------------------- PPA
    def area(self) -> Dict[str, float]:
        """Analytical GF12-calibrated area of the design point, in µm²
        (ready-valid FIFO overhead included when the spec asks for it)."""
        from .area import connection_box_area, switch_box_area
        if self.spec.ready_valid:
            rv = "split" if self.spec.split_fifo else "full"
            sb = switch_box_area(self._ic, rv=rv)
        else:
            sb = switch_box_area(self._ic)
        return {"sb_area": sb, "cb_area": connection_box_area(self._ic)}

    # ------------------------------------------------------------ bitstream
    def bitstream(self, cfg):
        """Configuration words for ``cfg``: a :class:`PnRResult` (route
        edges -> mux selects), a list of routed IR edges, or a raw
        ``(num_config,)`` select vector."""
        from .bitstream import BitstreamCodec
        if self._codec is None:
            self._codec = BitstreamCodec(self.fabric())
        codec = self._codec
        if hasattr(cfg, "route_edges"):
            return codec.words_for_route(cfg.route_edges())
        if (isinstance(cfg, (list, tuple)) and cfg
                and isinstance(cfg[0], tuple)
                and isinstance(cfg[0][0], Node)):
            return codec.words_for_route(cfg)
        return codec.encode(np.asarray(cfg, dtype=np.int32))


def compile_spec(spec: InterconnectSpec, core_fn=None,
                 device: DeviceLike = None,
                 use_kernels: bool = False,
                 passes=None,
                 analyze: str = "warn",
                 analyze_per_pass: bool = False) -> CompiledFabric:
    """The single front door (``canal_torch.compile``): compile a declarative
    :class:`InterconnectSpec` through the pass pipeline into a
    :class:`CompiledFabric`. ``passes`` overrides the default pipeline
    (a sequence of :class:`repro_torch.core.passes.IRPass`); ``analyze``
    gates the static analyzer (``"error"`` raises on error-severity
    findings, ``"warn"`` — the default — records the report on
    ``CompiledFabric.diagnostics``, ``"off"`` skips it) and
    ``analyze_per_pass`` attributes each finding to the pipeline pass
    that introduced it. ``device=None`` is the CUDA card (raises without
    CUDA); ``use_kernels`` selects the hand-written kernels for the
    fabric's fused engine."""
    from .passes import DEFAULT_PASSES, PassManager
    pm = PassManager(DEFAULT_PASSES if passes is None else passes)
    return pm.compile(spec, core_fn=core_fn, device=device,
                      use_kernels=use_kernels, analyze=analyze,
                      analyze_per_pass=analyze_per_pass)

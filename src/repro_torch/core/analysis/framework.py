"""The analysis-pass framework: ``IRPass``/``PassManager``'s read-only twin.

An :class:`AnalysisPass` is a named, registered *rule*: a pure function
``(AnalysisContext) -> Iterable[Diagnostic]`` over the frozen IR. Rules
never mutate the graph — they observe it and report. The registry mirrors
the compiler-pass registry so tooling can enumerate, subset and document
rules the same way it does passes; :func:`analyze` is the single driver
(``canal_torch.analyze``), used by the compile front door, the DSE pre-screen
and the ``python -m canal_torch.lint`` CLI.

The :class:`AnalysisContext` carries memoized whole-graph facts —
source/sink sets, forward/backward reachability, array-boundary
exemptions — so rules that share them (``dead-mux``,
``unreachable-node``, ``static-routability``) pay for one traversal, not
three.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

from ..graph import IO, Interconnect, InterconnectGraph, Node, SwitchBoxNode
from ..spec import InterconnectSpec
from .diagnostics import AnalysisReport, Diagnostic, Severity

RuleFn = Callable[["AnalysisContext"], Iterable[Diagnostic]]


@dataclass
class AnalysisContext:
    """Read-only state threaded through the rules: the IR, the spec when
    known (hand-built IR legitimately has none — spec-dependent rules
    gate themselves off), and memoized graph facts."""

    ic: Interconnect
    spec: Optional[InterconnectSpec] = None
    #: lowered FabricModule when the caller has one — enables the
    #: scope="lowered" rules (structural equivalence, config sweep)
    fabric: Optional[object] = None
    #: routed artifacts when the caller has a PnR result — enable the
    #: scope="routed" rules (rv-deadlock, throughput-bound, sta-slack,
    #: congestion-hotspot, x-propagation). ``packed`` is the
    #: :class:`PackedGraph`, ``routing`` the :class:`RoutingResult`
    #: (which carries its :class:`RoutingResources`), ``placement`` the
    #: instance -> (x, y) map and ``timing`` the STA summary dict.
    packed: Optional[object] = None
    routing: Optional[object] = None
    placement: Optional[Dict] = None
    timing: Optional[Dict] = None
    #: target clock period for slack checks; None = report-only (no
    #: period to violate, so ``sta-slack`` stays silent)
    clock_ns: Optional[float] = None
    _sources: Dict[int, Set[Node]] = field(default_factory=dict)
    _sinks: Dict[int, Set[Node]] = field(default_factory=dict)
    _fwd: Dict[int, Set[Node]] = field(default_factory=dict)
    _bwd: Dict[int, Set[Node]] = field(default_factory=dict)

    def graphs(self) -> List[InterconnectGraph]:
        return [self.ic.graphs[w] for w in self.ic.widths]

    # ----------------------------------------------------------- boundary
    @staticmethod
    def faces_off_array(g: InterconnectGraph, node: Node) -> bool:
        """True for switch-box nodes on a side with no neighbouring tile:
        the array's external interface (chip IO in a real CGRA). They
        legitimately have no on-array driver (SB_IN) or consumer
        (SB_OUT), so reachability rules treat them as sources/sinks
        rather than defects."""
        if not isinstance(node, SwitchBoxNode):
            return False
        dx, dy = node.side.delta()
        return g.get_tile(node.x + dx, node.y + dy) is None

    # -------------------------------------------------------- sources/sinks
    def sources(self, g: InterconnectGraph) -> Set[Node]:
        """Nodes that inject data into the routing graph: core *output*
        ports of this layer's width and array-boundary SB inputs.
        Registers are deliberately NOT sources — a register chain fed by
        nothing only ever replays reset values; reachability traverses
        *through* registers instead."""
        key = id(g)
        out = self._sources.get(key)
        if out is None:
            out = set()
            for tile in g.tiles.values():
                if tile.core is not None:
                    for p in tile.core.outputs():
                        if p.width == g.width:
                            out.add(tile.ports[p.name])
            for n in g.nodes():
                if (isinstance(n, SwitchBoxNode) and n.io == IO.SB_IN
                        and self.faces_off_array(g, n)):
                    out.add(n)
            self._sources[key] = out
        return out

    def sinks(self, g: InterconnectGraph) -> Set[Node]:
        """Nodes whose value is externally observable: core *input*
        ports of this layer's width and array-boundary SB outputs.
        Registers are deliberately NOT sinks — a register nobody reads
        is dead state; reachability traverses *through* registers
        instead."""
        key = id(g)
        out = self._sinks.get(key)
        if out is None:
            out = set()
            for tile in g.tiles.values():
                if tile.core is not None:
                    for p in tile.core.inputs():
                        if p.width == g.width:
                            out.add(tile.ports[p.name])
            for n in g.nodes():
                if (isinstance(n, SwitchBoxNode) and n.io == IO.SB_OUT
                        and self.faces_off_array(g, n)):
                    out.add(n)
            self._sinks[key] = out
        return out

    # --------------------------------------------------------- reachability
    def reachable_forward(self, g: InterconnectGraph) -> Set[Node]:
        """Nodes reachable from any source along fan-out edges."""
        key = id(g)
        out = self._fwd.get(key)
        if out is None:
            out = self._bfs(self.sources(g), lambda n: n.fan_out)
            self._fwd[key] = out
        return out

    def reaches_sink(self, g: InterconnectGraph) -> Set[Node]:
        """Nodes from which some sink is reachable (backward BFS)."""
        key = id(g)
        out = self._bwd.get(key)
        if out is None:
            out = self._bfs(self.sinks(g), lambda n: n.fan_in)
            self._bwd[key] = out
        return out

    @staticmethod
    def _bfs(seeds: Set[Node],
             nbrs: Callable[[Node], Sequence[Node]]) -> Set[Node]:
        seen = set(seeds)
        frontier = list(seeds)
        while frontier:
            n = frontier.pop()
            for m in nbrs(n):
                if m not in seen:
                    seen.add(m)
                    frontier.append(m)
        return seen


@dataclass(frozen=True)
class AnalysisPass:
    """A registered rule. ``name`` is the stable diagnostic id;
    ``when`` gates spec- or mode-dependent rules (e.g. ``rv-handshake``
    only applies to ready-valid designs); ``scope`` separates cheap IR
    rules (``"ir"``, run by default everywhere) from post-lowering
    verification (``"lowered"``: structural equivalence and the config
    sweep, which need a compiled :class:`FabricModule` and device time —
    reachable via ``CompiledFabric.verify()`` and ``canal_torch.lint
    --lowered``)."""

    name: str
    run: RuleFn
    description: str = ""
    scope: str = "ir"
    when: Callable[[AnalysisContext], bool] = lambda ctx: True
    #: the severity this rule's findings carry when it flags a defect —
    #: documentation for ``--list-rules`` and input to the rule-set
    #: version stamp; the rule body remains free to emit lower
    #: severities for secondary findings
    default_severity: Severity = Severity.ERROR


#: the rule registry, in registration order (report order follows it)
RULES: Dict[str, AnalysisPass] = {}


def register_rule(name: str, description: str = "", scope: str = "ir",
                  when: Callable[[AnalysisContext], bool] = lambda ctx: True,
                  default_severity: "str | Severity" = Severity.ERROR
                  ) -> Callable[[RuleFn], RuleFn]:
    """Decorator registering a rule function under a stable id — the
    analysis mirror of adding an :class:`IRPass` to ``DEFAULT_PASSES``.
    Re-registering an id replaces the rule (supports reload/monkeypatch
    in tests) but third-party ids must not collide with built-ins."""

    def deco(fn: RuleFn) -> RuleFn:
        RULES[name] = AnalysisPass(
            name=name, run=fn, description=description, scope=scope,
            when=when,
            default_severity=Severity.from_str(default_severity))
        return fn
    return deco


def rule_table(scope: Optional[str] = None) -> List[AnalysisPass]:
    """Registered rules (optionally one scope), registration-ordered."""
    return [r for r in RULES.values()
            if scope is None or r.scope == scope]


def rule_set_version(scope: Optional[str] = None) -> str:
    """Deterministic short hash of the registered rule set (ids, scopes,
    descriptions, default severities). Stamped onto persisted analysis
    verdicts (:class:`repro_torch.core.dse.SweepExecutor`) so a record written
    under an older rule set re-analyzes instead of serving a stale
    verdict — adding, removing or re-documenting a rule changes the
    stamp."""
    h = hashlib.sha256()
    for r in sorted(rule_table(scope), key=lambda r: r.name):
        h.update(f"{r.name}\x00{r.scope}\x00{r.description}\x00"
                 f"{int(r.default_severity)}\n".encode())
    return h.hexdigest()[:12]


def _resolve_spec(ic: Interconnect,
                  spec: Optional[InterconnectSpec]) -> Optional[
                      InterconnectSpec]:
    if spec is not None:
        return spec
    return getattr(ic, "spec", None)


def analyze(ic: Interconnect,
            spec: Optional[InterconnectSpec] = None,
            rules: Optional[Sequence[str]] = None,
            scope: str = "ir",
            severities: Optional[Dict[str, "str | Severity"]] = None,
            fail_on: Optional["str | Severity"] = None,
            fabric: Optional[object] = None,
            pnr: Optional[object] = None,
            packed: Optional[object] = None,
            routing: Optional[object] = None,
            placement: Optional[Dict] = None,
            timing: Optional[Dict] = None,
            clock_ns: Optional[float] = None) -> AnalysisReport:
    """Run the registered analysis rules over an interconnect IR.

    ``spec`` enables spec-dependent rules when the IR was not produced
    by the pass pipeline (pipeline IR carries its spec already);
    ``rules`` selects a subset by id (unknown ids raise — a misspelled
    CI config must fail loudly, not silently skip the check);
    ``severities`` remaps per-rule severity (project policy, e.g. demote
    ``dead-mux`` to info, or ``"off"`` to suppress a rule entirely;
    unknown rule ids raise); ``fail_on`` raises :class:`AnalysisError`
    when any finding reaches that severity. ``pnr`` (a successful
    :class:`repro_torch.core.pnr.PnRResult`) — or the individual ``packed`` /
    ``routing`` / ``placement`` / ``timing`` artifacts — enables the
    ``scope="routed"`` rules; ``clock_ns`` sets the target period the
    slack rules check against. This is the one driver behind
    ``canal_torch.compile(analyze=...)``, the DSE pre-screen and the lint CLI.
    """
    if not isinstance(ic, Interconnect) and hasattr(ic, "interconnect"):
        spec = spec if spec is not None else getattr(ic, "spec", None)
        ic = ic.interconnect                     # a CompiledFabric
    if pnr is not None:
        packed = packed if packed is not None else \
            getattr(pnr, "packed", None)
        routing = routing if routing is not None else \
            getattr(pnr, "routing", None)
        placement = placement if placement is not None else \
            getattr(pnr, "placement", None)
        timing = timing if timing is not None else \
            getattr(pnr, "timing", None)
    ctx = AnalysisContext(ic=ic, spec=_resolve_spec(ic, spec),
                          fabric=fabric, packed=packed, routing=routing,
                          placement=placement, timing=timing,
                          clock_ns=clock_ns)
    if rules is None:
        selected = rule_table(None if scope == "all" else scope)
    else:
        unknown = sorted(set(rules) - set(RULES))
        if unknown:
            raise ValueError(f"unknown analysis rules {unknown}; "
                             f"registered: {sorted(RULES)}")
        selected = [RULES[r] for r in rules]
    unknown_sev = sorted(set(severities or {}) - set(RULES))
    if unknown_sev:
        raise ValueError(f"unknown analysis rules in severities "
                         f"{unknown_sev}; registered: {sorted(RULES)}")
    suppressed = {k for k, v in (severities or {}).items()
                  if isinstance(v, str) and v.lower() == "off"}
    overrides = {k: Severity.from_str(v)
                 for k, v in (severities or {}).items()
                 if k not in suppressed}
    # suppressed rules did not run: leaving them out of rules_run keeps
    # "clean" distinguishable from "not checked"
    report = AnalysisReport(rules_run=tuple(
        r.name for r in selected if r.name not in suppressed))
    for r in selected:
        if r.name in suppressed or not r.when(ctx):
            continue
        found = list(r.run(ctx))
        sev = overrides.get(r.name)
        if sev is not None:
            found = [replace(d, severity=sev) for d in found]
        report.extend(found)
    if fail_on is not None:
        report.raise_if(fail_on)
    return report

"""The diagnostics model of ``canal_torch.analyze``.

A :class:`Diagnostic` is one finding of one analysis rule over the
interconnect IR: a stable rule id, a severity, a location (routing layer,
tile, node) and a human-readable message plus an actionable fix hint.
:class:`AnalysisReport` is the ordered collection the analyzer returns —
it renders as lint-style text, serializes to JSON for CI artifacts, and
carries the severity arithmetic (``ok()``, ``raise_if()``) the compile
front door and the DSE pre-screen gate on.
"""
from __future__ import annotations

import enum
import json
from dataclasses import asdict, dataclass, field, replace
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


class Severity(enum.IntEnum):
    """Ordered: comparisons like ``d.severity >= Severity.WARNING`` give
    threshold filtering for free."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    @classmethod
    def from_str(cls, s: "str | Severity") -> "Severity":
        if isinstance(s, Severity):
            return s
        try:
            return _SEVERITY_ALIASES[s.lower()]
        except (KeyError, AttributeError):
            raise ValueError(
                f"unknown severity {s!r}; use one of "
                f"{sorted(set(_SEVERITY_ALIASES))}") from None


_SEVERITY_ALIASES: Dict[str, Severity] = {
    "info": Severity.INFO,
    "warn": Severity.WARNING, "warning": Severity.WARNING,
    "error": Severity.ERROR,
}


@dataclass(frozen=True)
class Diagnostic:
    """One finding: ``rule`` is the stable lint id (kebab-case, the thing
    CI configs and suppressions key on), location is as precise as the
    rule can make it (``width`` = routing layer bit width, ``tile`` =
    (x, y), ``node`` = ``node_key()`` repr), and ``pass_name`` — filled
    by the per-pass pipeline mode — names the first IR pass after which
    the finding appears."""

    rule: str
    severity: Severity
    message: str
    width: Optional[int] = None          # routing layer (graph bit width)
    tile: Optional[Tuple[int, int]] = None
    node: Optional[str] = None           # node_key() repr
    hint: Optional[str] = None
    pass_name: Optional[str] = None

    def location(self) -> str:
        parts = []
        if self.width is not None:
            parts.append(f"layer{self.width}b")
        if self.tile is not None:
            parts.append(f"tile({self.tile[0]},{self.tile[1]})")
        if self.node is not None:
            parts.append(self.node)
        return ":".join(parts) if parts else "<design>"

    def key(self) -> Tuple:
        """Identity used to match findings across pipeline snapshots (the
        per-pass attribution) and to dedupe: the rule plus the location —
        *not* the message, which may carry run-varying counts."""
        return (self.rule, self.width, self.tile, self.node)

    def with_pass(self, pass_name: str) -> "Diagnostic":
        return replace(self, pass_name=pass_name)

    def to_dict(self) -> Dict:
        d = asdict(self)
        d["severity"] = self.severity.name.lower()
        if self.tile is not None:
            d["tile"] = list(self.tile)
        return d

    def render(self) -> str:
        origin = f" [{self.pass_name}]" if self.pass_name else ""
        hint = f" (hint: {self.hint})" if self.hint else ""
        return (f"{self.severity.name.lower()}: {self.rule} @ "
                f"{self.location()}: {self.message}{origin}{hint}")

    def __str__(self) -> str:
        return self.render()


class AnalysisError(RuntimeError):
    """Raised by ``analyze="error"`` compiles: the report rode along so
    callers can inspect every finding, not just the first."""

    def __init__(self, report: "AnalysisReport", level: Severity):
        self.report = report
        self.level = level
        bad = report.at_least(level)
        lines = "\n".join(f"  {d.render()}" for d in bad[:8])
        more = f"\n  ... and {len(bad) - 8} more" if len(bad) > 8 else ""
        super().__init__(
            f"static analysis found {len(bad)} finding(s) at severity "
            f">= {level.name.lower()}:\n{lines}{more}")


@dataclass
class AnalysisReport:
    """The analyzer's output: diagnostics in rule-registration order,
    plus the set of rule ids that actually ran (so "clean" is
    distinguishable from "not checked")."""

    diagnostics: List[Diagnostic] = field(default_factory=list)
    rules_run: Tuple[str, ...] = ()

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    # ------------------------------------------------------------ filtering
    def at_least(self, level: "str | Severity") -> List[Diagnostic]:
        level = Severity.from_str(level)
        return [d for d in self.diagnostics if d.severity >= level]

    @property
    def errors(self) -> List[Diagnostic]:
        return self.at_least(Severity.ERROR)

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.WARNING]

    def by_rule(self, rule: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.rule == rule]

    def rule_ids(self) -> List[str]:
        seen: Dict[str, None] = {}
        for d in self.diagnostics:
            seen.setdefault(d.rule, None)
        return list(seen)

    # -------------------------------------------------------------- gating
    def ok(self, fail_on: "str | Severity" = Severity.ERROR) -> bool:
        """True when no finding reaches ``fail_on`` — the CI exit-code
        predicate and the DSE pre-screen verdict."""
        return not self.at_least(fail_on)

    def raise_if(self, level: "str | Severity" = Severity.ERROR) -> None:
        level = Severity.from_str(level)
        if not self.ok(level):
            raise AnalysisError(self, level)

    # ------------------------------------------------------- serialization
    def counts(self) -> Dict[str, int]:
        out = {"error": 0, "warning": 0, "info": 0}
        for d in self.diagnostics:
            out[d.severity.name.lower()] += 1
        return out

    def to_dict(self, max_diagnostics: Optional[int] = None) -> Dict:
        diags = self.diagnostics
        truncated = 0
        if max_diagnostics is not None and len(diags) > max_diagnostics:
            # keep the most severe findings when truncating for storage
            diags = sorted(diags, key=lambda d: -int(d.severity))
            truncated = len(diags) - max_diagnostics
            diags = diags[:max_diagnostics]
        out = {"clean": self.ok(), "counts": self.counts(),
               "rules_run": list(self.rules_run),
               "diagnostics": [d.to_dict() for d in diags]}
        if truncated:
            out["truncated"] = truncated
        return out

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def render(self) -> str:
        c = self.counts()
        lines = [d.render() for d in self.diagnostics]
        lines.append(f"{c['error']} error(s), {c['warning']} warning(s), "
                     f"{c['info']} info in {len(self.rules_run)} rule(s)")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        c = self.counts()
        return (f"AnalysisReport(errors={c['error']}, "
                f"warnings={c['warning']}, info={c['info']})")

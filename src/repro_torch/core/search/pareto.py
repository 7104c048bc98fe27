"""Pareto machinery for the DSE optimizer.

The search optimizes the (area, critical-path delay, routability)
triple :func:`repro_torch.core.store.record_metrics` stamps on every record:
smaller area, smaller delay, larger routability. :func:`dominates` is
the partial order, :func:`pareto_frontier` the non-dominated subset,
and :func:`best_point` the scalarized pick the single-objective verbs
(``recommend``, the greedy selector's incumbent) use — an objective to
minimize plus optional hard constraints.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..spec import InterconnectSpec
from ..store import record_metrics

#: metric keys and their sense: True = minimize, False = maximize.
#: ``throughput`` (static tokens/cycle bound) and ``min_slack_ns``
#: (worst per-net slack vs the reference clock) come from the routed
#: static analyzer and appear only on records whose apps carry the
#: static stamps — the dominance/constraint machinery treats them as
#: optional (see :func:`dominates` / :func:`satisfies`).
METRIC_SENSE = {"area": True, "critical_path_ns": True,
                "routability": False, "throughput": False,
                "min_slack_ns": False}

#: constraint keys accepted by :func:`satisfies`
CONSTRAINT_KEYS = ("max_area", "max_critical_path_ns", "min_routability",
                   "min_throughput", "min_slack_ns")


@dataclass
class Evaluated:
    """One evaluated design point: the spec, its store address, the DSE
    record, the frontier metrics, and the static-validity verdict
    (``valid=False`` — analyzer-rejected or unroutable — points are
    archived for dedup but never enter the frontier)."""
    spec: InterconnectSpec
    digest: str
    record: Dict
    metrics: Dict[str, float]
    valid: bool

    def to_dict(self, include_record: bool = False) -> Dict:
        out = {"spec": self.spec.canonical_dict(), "digest": self.digest,
               "metrics": dict(self.metrics), "valid": self.valid}
        if include_record:
            out["record"] = self.record
        return out


#: the always-present metric triple every record summarizes to
_CORE_METRICS = ("area", "critical_path_ns", "routability")

#: pessimistic fallbacks for the optional routed metrics when a point
#: predates them: no throughput claim and no slack headroom — a point
#: that never ran the routed analyzer cannot win on what it never
#: measured
_METRIC_DEFAULTS = {"area": float("inf"),
                    "critical_path_ns": float("inf"),
                    "routability": 0.0, "throughput": 0.0,
                    "min_slack_ns": float("-inf")}


def point_metrics(record: Dict) -> Dict[str, float]:
    """Frontier metrics of a DSE record: the stamped ``metrics`` field
    when present (compute-time or merge-time stamp), else re-derived.
    A stamp is honored for the keys it carries (it may be the exact
    three-key shape of pre-routed-analyzer records, or carry the
    optional ``throughput`` / ``min_slack_ns``); core keys it lacks are
    filled from :func:`record_metrics`."""
    m = record.get("metrics")
    if isinstance(m, dict) and set(_CORE_METRICS) <= set(m):
        out = {k: float(m[k]) for k in METRIC_SENSE if k in m}
        if len(out) < len(METRIC_SENSE):
            derived = record_metrics(record)
            for k, v in derived.items():
                out.setdefault(k, float(v))
        return out
    return record_metrics(record)


def dominates(a: Dict[str, float], b: Dict[str, float]) -> bool:
    """Pareto dominance: ``a`` is no worse than ``b`` on every metric
    (<= on minimized, >= on maximized) and strictly better on at least
    one. Ties on every metric dominate in neither direction. Only
    metrics *both* points carry participate — the optional routed
    metrics never disqualify a point that predates them."""
    strict = False
    for key, minimize in METRIC_SENSE.items():
        if key not in a or key not in b:
            continue
        av, bv = a[key], b[key]
        if minimize:
            if av > bv:
                return False
            strict = strict or av < bv
        else:
            if av < bv:
                return False
            strict = strict or av > bv
    return strict


def pareto_frontier(points: List[Evaluated]) -> List[Evaluated]:
    """The non-dominated subset of the *valid* points, in
    first-appearance order: a point survives iff no other valid point
    strictly dominates it. Metric-identical points dominate in neither
    direction, so ties all stay — every excluded point is *strictly*
    dominated by some frontier point (the invariant the property tests
    pin)."""
    frontier: List[Evaluated] = []
    for p in points:
        if not p.valid:
            continue
        if any(dominates(q.metrics, p.metrics) for q in frontier):
            continue
        frontier = [q for q in frontier
                    if not dominates(p.metrics, q.metrics)]
        frontier.append(p)
    return frontier


def objective_value(metrics: Dict[str, float], objective: str) -> float:
    """Scalarize one metric for minimization (maximized metrics are
    negated, so ``min`` over objective values always means "best")."""
    if objective not in METRIC_SENSE:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of {sorted(METRIC_SENSE)}")
    v = float(metrics.get(objective, _METRIC_DEFAULTS[objective]))
    return v if METRIC_SENSE[objective] else -v


def satisfies(metrics: Dict[str, float],
              constraints: Optional[Dict[str, float]]) -> bool:
    """Hard-constraint check: ``max_area``, ``max_critical_path_ns``,
    ``min_routability``, ``min_throughput`` (static tokens/cycle bound
    from the routed analyzer), ``min_slack_ns`` (worst per-net slack vs
    the reference clock). Points lacking an optional routed metric get
    the pessimistic default (no throughput, no slack) — a constraint on
    what was never measured excludes them. Unknown keys raise (a typo'd
    constraint must not silently admit everything)."""
    if not constraints:
        return True
    for key, bound in constraints.items():
        if key == "max_area":
            ok = metrics["area"] <= bound
        elif key == "max_critical_path_ns":
            ok = metrics["critical_path_ns"] <= bound
        elif key == "min_routability":
            ok = metrics["routability"] >= bound
        elif key == "min_throughput":
            ok = metrics.get("throughput", 0.0) >= bound
        elif key == "min_slack_ns":
            ok = metrics.get("min_slack_ns", float("-inf")) >= bound
        else:
            raise ValueError(f"unknown constraint {key!r}; "
                             f"one of {CONSTRAINT_KEYS}")
        if not ok:
            return False
    return True


def best_point(points: List[Evaluated], objective: str = "area",
               constraints: Optional[Dict[str, float]] = None,
               strict: bool = True) -> Optional[Evaluated]:
    """Best valid point by ``objective`` among those satisfying
    ``constraints``. With ``strict`` (the default) an infeasible set
    yields None; ``strict=False`` falls back to the best objective
    value ignoring constraints — the greedy selector's gradient signal
    while it is still outside the feasible region. Deterministic: ties
    go to the earliest point."""
    feasible = [p for p in points
                if p.valid and satisfies(p.metrics, constraints)]
    if not feasible and not strict:
        feasible = [p for p in points if p.valid]
    if not feasible:
        return None
    return min(feasible,
               key=lambda p: objective_value(p.metrics, objective))


@dataclass
class SearchResult:
    """What :func:`repro_torch.core.search.search` returns: the Pareto
    frontier, every evaluated point, and run statistics."""
    frontier: List[Evaluated]
    evaluated: List[Evaluated]
    stats: Dict = field(default_factory=dict)

    def best(self, objective: str = "area",
             constraints: Optional[Dict[str, float]] = None
             ) -> Optional[Evaluated]:
        """Scalarized pick over the evaluated points (strict: None when
        nothing satisfies the constraints)."""
        return best_point(self.evaluated, objective, constraints)

    def to_dict(self, include_records: bool = False) -> Dict:
        return {"frontier": [p.to_dict(include_records)
                             for p in self.frontier],
                "evaluated": [p.to_dict(include_records)
                              for p in self.evaluated],
                "stats": self.stats}

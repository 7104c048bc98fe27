"""The search driver: selector proposes, executor evaluates, frontier
accumulates.

``search()`` turns the grid-sweep substrate into an optimizer: each
round the selector proposes a candidate batch, the batch is evaluated
through a single :meth:`repro_torch.core.dse.SweepExecutor.run_points` call —
store-memoized (repeat searches are pure store hits, zero PnR),
statically-invalid candidates pruned for free by the analyzer verdict
already on the record — and the evaluated points feed the selector and
the Pareto frontier over (area, critical-path delay, routability).
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

from ..spec import InterconnectSpec
from .pareto import Evaluated, SearchResult, pareto_frontier, \
    point_metrics
from .selectors import make_selector
from .space import SearchSpace


def _point_valid(rec: Dict) -> bool:
    """Statically valid and not skipped: the analyzer said ``clean`` (or
    predates the analysis field) and no app was skipped pre-PnR."""
    analysis = rec.get("analysis")
    if isinstance(analysis, dict) and not analysis.get("clean", True):
        return False
    apps = rec.get("apps") or {}
    return not any(isinstance(a, dict) and a.get("skipped")
                   for a in apps.values())


def search(base: Optional[InterconnectSpec] = None,
           axes: Optional[Dict] = None, *,
           space: Optional[SearchSpace] = None,
           selector: str = "greedy",
           objective: str = "area",
           constraints: Optional[Dict[str, float]] = None,
           budget: int = 32, batch_size: int = 4, seed: int = 0,
           executor: Any = None, store: Any = None,
           apps: Optional[Dict] = None, emulate_cycles: int = 0,
           selector_options: Optional[Dict] = None,
           use_kernels: bool = True,
           max_workers: Optional[int] = None,
           **executor_kwargs) -> SearchResult:
    """Search-driven design-space exploration over ``InterconnectSpec``
    space (exported as ``canal_torch.search``).

    Pass ``base`` + ``axes`` (the ``spec_grid`` shape) or a prebuilt
    :class:`SearchSpace`. ``selector`` is ``"random"``, ``"greedy"`` or
    ``"evolutionary"`` (:mod:`.selectors`); ``objective`` one of
    ``area`` / ``critical_path_ns`` / ``routability``; ``constraints``
    e.g. ``{"max_critical_path_ns": 5.0, "min_routability": 1.0}``.
    ``budget`` caps evaluated candidates, proposed ``batch_size`` at a
    time (one batched executor pass each — shared caches, concurrent
    points, batched emulation).

    An existing ``executor`` (e.g. a :class:`DSEService`'s) is reused
    as configured; otherwise one is built from ``store`` / ``apps`` /
    ``emulate_cycles`` / ``use_kernels`` and the remaining kwargs
    (``device=`` among them: ``None`` is the CUDA card).
    Returns a :class:`SearchResult` — ``frontier`` (non-dominated valid
    points), ``evaluated`` (everything), ``stats`` (round counts plus
    the executor counter deltas, so "zero new PnR on the re-run" is one
    assertion away)."""
    if space is None:
        if base is None or axes is None:
            raise TypeError("pass base + axes, or space=SearchSpace(...)")
        space = SearchSpace(base, axes)
    elif base is not None or axes is not None:
        raise TypeError("pass base + axes or space, not both")
    if budget < 1:
        raise ValueError("budget must be >= 1")
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    if executor is not None and (store is not None or apps is not None
                                 or executor_kwargs):
        raise TypeError("pass executor kwargs or a prebuilt executor, "
                        "not both")
    if executor is None:
        from ..dse import SweepExecutor
        executor = SweepExecutor(apps=apps, store=store,
                                 emulate_cycles=emulate_cycles,
                                 use_kernels=use_kernels,
                                 max_workers=max_workers,
                                 **executor_kwargs)

    rng = random.Random(seed)
    sel = make_selector(selector, space, rng, objective=objective,
                        constraints=constraints,
                        **(selector_options or {}))
    before = executor.stats()
    evaluated: List[Evaluated] = []
    evaluated_specs: set = set()
    rounds = proposed = invalid = stalls = 0
    while len(evaluated) < budget:
        n = min(batch_size, budget - len(evaluated))
        cands = sel.propose(n)
        if not cands:
            break  # selector exhausted the space
        rounds += 1
        proposed += len(cands)
        # driver-side dedup: a selector re-proposing an evaluated spec
        # must not burn budget on it (the executor would just serve the
        # store record again)
        cands = [s for s in cands if s not in evaluated_specs][:n]
        if not cands:
            # the bundled selectors never re-propose; a custom one that
            # keeps doing so must not spin the loop forever
            stalls += 1
            if stalls >= 3:
                break
            continue
        stalls = 0
        recs = executor.run_specs(cands, record=False)
        batch: List[Evaluated] = []
        for cand, rec in zip(cands, recs):
            valid = _point_valid(rec)
            if not valid:
                invalid += 1
            ev = Evaluated(spec=cand, digest=rec.get("spec_digest", ""),
                           record=rec, metrics=point_metrics(rec),
                           valid=valid)
            batch.append(ev)
            evaluated.append(ev)
            evaluated_specs.add(cand)
        sel.observe(batch)
    after = executor.stats()
    stats = {"selector": str(getattr(selector, "value", selector)),
             "objective": objective,
             "constraints": dict(constraints or {}),
             "budget": budget, "rounds": rounds,
             "proposed": proposed, "evaluated": len(evaluated),
             "statically_invalid": invalid,
             "space_size": space.size(),
             "executor": {k: after[k] - before[k] for k in after}}
    frontier = pareto_frontier(evaluated)
    stats["frontier_size"] = len(frontier)
    return SearchResult(frontier=frontier, evaluated=evaluated,
                        stats=stats)

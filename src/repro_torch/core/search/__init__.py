"""Search-driven design-space exploration (the optimizer front end).

The grid sweeps of :mod:`repro_torch.core.dse` enumerate; this package
*searches*: a :class:`SearchSpace` of axes over
:class:`~repro_torch.core.spec.InterconnectSpec`, pluggable
:class:`~.selectors.Selector` policies (random / greedy local mutation
/ evolutionary), and a :func:`search` driver that batches candidate
evaluation through one store-memoized
:meth:`~repro_torch.core.dse.SweepExecutor.run_points` call per round while
maintaining a Pareto frontier over (area, critical-path delay,
routability).

Entry points: ``canal_torch.search(...)`` (this :func:`search`),
``DSEService.recommend(...)`` (the serving verb), and
``python -m canal_torch.search`` (the CLI, :mod:`.cli`).
"""
from .driver import search
from .pareto import (Evaluated, SearchResult, best_point, dominates,
                     pareto_frontier, point_metrics)
from .selectors import (EvolutionarySelector, GreedySelector,
                        RandomSelector, Selector, SelectorKind,
                        make_selector)
from .space import SearchSpace

__all__ = [
    "search", "SearchSpace", "SearchResult", "Evaluated",
    "dominates", "pareto_frontier", "best_point", "point_metrics",
    "Selector", "SelectorKind", "make_selector",
    "RandomSelector", "GreedySelector", "EvolutionarySelector",
]

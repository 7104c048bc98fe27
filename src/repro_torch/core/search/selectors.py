"""Pluggable candidate selectors for the DSE search driver.

One protocol — :class:`Selector` — behind which the proposal policies
live, mirroring the selector-enum shape of rapidstream-noc's
``noc_pass`` (RANDOM / GREEDY / solver-backed): :class:`SelectorKind`
names the policies, :func:`make_selector` builds one.

A selector alternates ``propose(n)`` (up to ``n`` unseen candidate
specs) with ``observe(evaluated)`` (the driver feeding back the
evaluated batch, statically-invalid points included). All randomness
flows from the driver's seeded ``random.Random`` — same seed, same
proposal stream. ``propose`` returning ``[]`` means the selector has
exhausted the space (or its neighborhood) and the search stops early.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Protocol

from ..spec import InterconnectSpec
from .pareto import Evaluated, best_point, pareto_frontier
from .space import SearchSpace


class SelectorKind(str, enum.Enum):
    """Selector policies (the ``selector=`` knob of ``canal_torch.search``)."""
    RANDOM = "random"
    GREEDY = "greedy"
    EVOLUTIONARY = "evolutionary"


class Selector(Protocol):
    """The pluggable policy interface the driver loops over."""

    def propose(self, n: int) -> List[InterconnectSpec]:
        """Up to ``n`` unseen candidates; ``[]`` = exhausted."""
        ...

    def observe(self, evaluated: List[Evaluated]) -> None:
        """Feed back the evaluated batch (archive + adapt)."""
        ...


def _random_unseen(space: SearchSpace, rng, seen, n: int
                   ) -> List[InterconnectSpec]:
    """Up to ``n`` unseen uniform samples. Bounded rejection sampling
    first (cheap while the space is mostly unseen); when the space is
    small enough to enumerate, fall back to a shuffled sweep of the
    remaining grid so exhaustion is detected exactly instead of
    probabilistically."""
    out: List[InterconnectSpec] = []
    batch_seen = set()
    for _ in range(max(20 * n, 100)):
        if len(out) >= n:
            return out
        cand = space.sample(rng)
        if cand not in seen and cand not in batch_seen:
            batch_seen.add(cand)
            out.append(cand)
    if len(out) < n and space.size() <= 4096:
        rest = [s for s in space.grid()
                if s not in seen and s not in batch_seen]
        rng.shuffle(rest)
        out.extend(rest[:n - len(out)])
    return out


class RandomSelector:
    """Uniform exploration — the baseline every adaptive selector must
    beat, and the coverage workhorse for tiny spaces (it enumerates
    them exactly, never proposing a duplicate)."""

    def __init__(self, space: SearchSpace, rng, **_ignored):
        self.space = space
        self.rng = rng
        self.seen: set = set()

    def propose(self, n: int) -> List[InterconnectSpec]:
        cands = _random_unseen(self.space, self.rng, self.seen, n)
        self.seen.update(cands)
        return cands

    def observe(self, evaluated: List[Evaluated]) -> None:
        self.seen.update(p.spec for p in evaluated)


class GreedySelector:
    """Local search: walk the axis-neighborhood of the incumbent (the
    best point so far by the scalarized objective, constraint-feasible
    preferred), proposing its unseen neighbors each round. When the
    neighborhood is exhausted — a local optimum — restart from a random
    unseen point rather than stopping, until the budget runs out or the
    space is exhausted."""

    def __init__(self, space: SearchSpace, rng,
                 objective: str = "area",
                 constraints: Optional[Dict[str, float]] = None,
                 **_ignored):
        self.space = space
        self.rng = rng
        self.objective = objective
        self.constraints = constraints
        self.seen: set = set()
        self.archive: List[Evaluated] = []

    def _incumbent(self) -> Optional[Evaluated]:
        # strict=False: while nothing satisfies the constraints yet the
        # best unconstrained point still provides a descent direction
        return best_point(self.archive, self.objective,
                          self.constraints, strict=False)

    def propose(self, n: int) -> List[InterconnectSpec]:
        cands: List[InterconnectSpec] = []
        inc = self._incumbent()
        if inc is None:
            start = self.space.origin()
            cands = ([start] if start not in self.seen
                     else _random_unseen(self.space, self.rng,
                                         self.seen, 1))
        else:
            cands = [s for s in self.space.neighbors(inc.spec)
                     if s not in self.seen][:n]
            if not cands:
                # local optimum: random restart keeps the budget useful
                cands = _random_unseen(self.space, self.rng,
                                       self.seen, 1)
        self.seen.update(cands)
        return cands[:n]

    def observe(self, evaluated: List[Evaluated]) -> None:
        self.seen.update(p.spec for p in evaluated)
        self.archive.extend(evaluated)


class EvolutionarySelector:
    """Pareto-archive evolution: parents are the current frontier of
    the valid archive; children are axis-crossovers of two parents with
    a mutation step, deduplicated against everything seen; random
    unseen samples fill the remainder (and are the entire first
    generation)."""

    def __init__(self, space: SearchSpace, rng,
                 mutation_rate: float = 0.5, **_ignored):
        self.space = space
        self.rng = rng
        self.mutation_rate = mutation_rate
        self.seen: set = set()
        self.archive: List[Evaluated] = []

    def _crossover(self, a: InterconnectSpec, b: InterconnectSpec
                   ) -> InterconnectSpec:
        from dataclasses import replace
        pinned = {name: getattr(self.rng.choice((a, b)), name)
                  for name in self.space.axes}
        return replace(self.space.base, **pinned)

    def propose(self, n: int) -> List[InterconnectSpec]:
        parents = pareto_frontier(self.archive)
        cands: List[InterconnectSpec] = []
        batch_seen = set()
        if parents:
            for _ in range(10 * n):
                if len(cands) >= n:
                    break
                a = self.rng.choice(parents).spec
                b = self.rng.choice(parents).spec
                child = self._crossover(a, b)
                if self.rng.random() < self.mutation_rate:
                    child = self.space.mutate(child, self.rng)
                if child not in self.seen and child not in batch_seen:
                    batch_seen.add(child)
                    cands.append(child)
        if len(cands) < n:
            fill = _random_unseen(self.space, self.rng,
                                  self.seen | batch_seen,
                                  n - len(cands))
            cands.extend(fill)
        self.seen.update(cands)
        return cands

    def observe(self, evaluated: List[Evaluated]) -> None:
        self.seen.update(p.spec for p in evaluated)
        self.archive.extend(evaluated)


_REGISTRY = {
    SelectorKind.RANDOM: RandomSelector,
    SelectorKind.GREEDY: GreedySelector,
    SelectorKind.EVOLUTIONARY: EvolutionarySelector,
}


def make_selector(kind, space: SearchSpace, rng,
                  objective: str = "area",
                  constraints: Optional[Dict[str, float]] = None,
                  **options) -> Selector:
    """Build a selector by kind (a :class:`SelectorKind` or its string
    value). Unknown kinds raise with the valid names listed."""
    try:
        kind = SelectorKind(kind)
    except ValueError:
        raise ValueError(
            f"unknown selector {kind!r}; one of "
            f"{[k.value for k in SelectorKind]}") from None
    cls = _REGISTRY[kind]
    return cls(space, rng, objective=objective,
               constraints=constraints, **options)

"""Search space over :class:`~repro_torch.core.spec.InterconnectSpec`.

A :class:`SearchSpace` is a base spec plus named axes — the same
``{field: values}`` shape :func:`repro_torch.core.spec.spec_grid` sweeps
exhaustively — with the mutation/neighborhood operators the selectors
need: uniform sampling, single-axis mutation, adjacent-value neighbors,
and full enumeration for small spaces. Axes are canonicalized once at
construction (:func:`repro_torch.core.spec.spec_axes`): unknown fields and
unconstructible values fail here, with the axis named, not deep inside
a search run.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Iterator, List, Sequence, Tuple

from ..spec import (InterconnectSpec, mutate_spec, neighbor_specs,
                    spec_axes, spec_grid)


class SearchSpace:
    """Axes over a base spec, with selector operators.

    Membership, sampling and enumeration all range over the *projected*
    grid: every point is ``base`` with each axis field set to one of its
    allowed values (off-axis fields pinned at the base's values)."""

    def __init__(self, base: InterconnectSpec,
                 axes: Dict[str, Sequence]):
        if not isinstance(base, InterconnectSpec):
            raise TypeError("base must be an InterconnectSpec, got "
                            f"{type(base).__name__}")
        if not axes:
            raise ValueError("a SearchSpace needs at least one axis")
        self.base = base
        self.axes: Dict[str, Tuple] = spec_axes(base, axes)

    # ------------------------------------------------------------ geometry
    def size(self) -> int:
        """Number of points in the full grid (the search's upper bound —
        a selector earning its keep evaluates fewer)."""
        n = 1
        for vals in self.axes.values():
            n *= len(vals)
        return n

    def grid(self) -> List[InterconnectSpec]:
        """Every point, axis-major order (deterministic)."""
        return [s for s, _ in spec_grid(self.base, self.axes)]

    def __iter__(self) -> Iterator[InterconnectSpec]:
        return iter(self.grid())

    def __len__(self) -> int:
        return self.size()

    def contains(self, spec: InterconnectSpec) -> bool:
        """Whether ``spec`` lies on the projected grid: every axis field
        at an allowed value, every off-axis field equal to the base's."""
        for name, vals in self.axes.items():
            if getattr(spec, name) not in vals:
                return False
        pinned = {n: getattr(spec, n) for n in self.axes}
        return replace(self.base, **pinned) == spec

    def origin(self) -> InterconnectSpec:
        """The canonical start point: the base projected onto the grid —
        axis fields already at an allowed value stay, others snap to the
        axis's middle value (a central start gives a local search the
        most room in both directions)."""
        pinned = {}
        for name, vals in self.axes.items():
            cur = getattr(self.base, name)
            pinned[name] = cur if cur in vals else vals[len(vals) // 2]
        return replace(self.base, **pinned)

    # ----------------------------------------------------------- operators
    def sample(self, rng) -> InterconnectSpec:
        """One uniform grid point."""
        pinned = {name: rng.choice(vals)
                  for name, vals in self.axes.items()}
        return replace(self.base, **pinned)

    def mutate(self, spec: InterconnectSpec, rng) -> InterconnectSpec:
        """Single-axis local mutation (:func:`spec.mutate_spec`)."""
        return mutate_spec(spec, self.axes, rng)

    def neighbors(self, spec: InterconnectSpec) -> List[InterconnectSpec]:
        """Adjacent grid points (:func:`spec.neighbor_specs`),
        deterministic order."""
        return neighbor_specs(spec, self.axes)

    # --------------------------------------------------------------- misc
    def to_dict(self) -> Dict:
        """JSON-safe description (CLI/artifact output)."""
        from ..spec import _json_safe
        return {"base": self.base.canonical_dict(),
                "axes": {n: [_json_safe(v) for v in vals]
                         for n, vals in self.axes.items()},
                "size": self.size()}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        dims = "x".join(str(len(v)) for v in self.axes.values())
        return (f"SearchSpace(axes={list(self.axes)}, "
                f"dims={dims}, size={self.size()})")

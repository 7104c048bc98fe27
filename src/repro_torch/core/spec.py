"""The declarative design-point description: a frozen ``InterconnectSpec``.

This is the single canonical input of the Canal compiler front door
(``canal_torch.compile``): everything that defines an interconnect design point
— array size, switch-box topology, tracks/width/layers, pipeline register
density, core-port connections, ready-valid mode, and route/emulation
knobs — lives in one frozen, hashable, JSON-round-trippable dataclass.

Why frozen + serializable: design-space sweeps live or die on a canonical
design-point key. ``spec.digest()`` (sha256 over the canonical JSON form)
keys every cache in :mod:`repro_torch.core.dse` — interconnects,
``RoutingResources``, ``FabricModule`` — and is stable across process
restarts and dict key orderings, unlike the old raw-kwargs tuples (which
broke on callables and nested values and embedded ``repr`` ids).

The spec is *data only*. Turning it into an IR graph is the job of the
pass pipeline in :mod:`repro_torch.core.passes`; escape hatches that cannot be
serialized (custom ``core_fn`` callables, hand-built graphs) stay on the
compile call, not on the spec.
"""
from __future__ import annotations

import enum
import hashlib
import itertools
import json
from dataclasses import dataclass, field, fields, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .graph import Side


class SwitchBoxType(enum.Enum):
    DISJOINT = "disjoint"
    WILTON = "wilton"
    IMRAN = "imran"


# Reduction order for the port-connection DSE (Fig. 12): 4 sides, then drop
# EAST, then drop SOUTH.
SIDE_REDUCTION_ORDER: Tuple[Side, ...] = (Side.NORTH, Side.WEST, Side.SOUTH,
                                          Side.EAST)


def sides_for(n: int) -> Tuple[Side, ...]:
    """First n sides in the paper's reduction order (Fig. 12)."""
    if not 1 <= n <= 4:
        raise ValueError("side count must be in 1..4")
    return SIDE_REDUCTION_ORDER[:n]


_ROUTE_STRATEGIES = (None, "python", "minplus", "auto")
_PLACE_STRATEGIES = (None, "python", "batched", "auto")


@dataclass(frozen=True)
class InterconnectSpec:
    """A complete, immutable description of one interconnect design point.

    Hashable (usable as a dict key), JSON-round-trippable
    (``from_json(spec.to_json()) == spec``) and digestible
    (``spec.digest()`` is stable across processes and key orderings).
    Derive variants with :func:`dataclasses.replace` or :func:`spec_grid`.
    """

    width: int = 8                  # array width in tiles
    height: int = 8                 # array height in tiles
    track_width: int = 16           # routing track bit width
    num_tracks: int = 5             # tracks per side
    sb_type: SwitchBoxType = SwitchBoxType.WILTON
    reg_density: float = 1.0        # fraction of tracks with pipeline regs
    cb_sides: int = 4               # sides feeding CBs (core inputs)
    sb_sides: int = 4               # sides fed by core outputs
    cb_track_fc: float = 1.0        # fraction of tracks a CB connects to
    sb_track_fc: float = 1.0        # fraction of tracks a core output drives
    mem_columns: Tuple[int, ...] = ()
    io_ring: bool = False
    pe_inputs: int = 4
    pe_outputs: int = 2
    wire_delay: float = 0.12        # ns per inter-tile hop
    mux_delay: float = 0.06         # ns per SB mux
    cb_delay: float = 0.05          # ns through CB mux
    #: additional routing layers as ((bit_width, num_tracks), ...) pairs;
    #: a plain {width: tracks} dict is accepted and canonicalized
    extra_layers: Tuple[Tuple[int, int], ...] = ()
    # ready-valid support (hybrid interconnect, §3.3)
    ready_valid: bool = False
    fifo_depth: int = 2
    split_fifo: bool = False
    # route/emulation knobs (consumed by PnR and the DSE executor, not by
    # IR construction)
    route_strategy: Optional[str] = None   # None = caller default
    #: "auto" strategy threshold override (tiles); None = env/module default
    auto_min_tiles: Optional[int] = None
    #: ext-IO streaming chunk for batched emulation; None = caller default
    emulate_io_chunk: Optional[int] = None
    # PnR knobs folded from SweepExecutor (PR 5): a design point now fully
    # describes *how* it is placed and routed, so its digest addresses the
    # persistent result store. None = caller/executor default. All are
    # digest-optional (see DIGEST_OPTIONAL): while unset they are omitted
    # from the canonical JSON, keeping pre-existing digests stable.
    reg_penalty: Optional[float] = None        # router register-hop penalty
    alphas: Optional[Tuple[float, ...]] = None  # placement α sweep (§3.4)
    sa_steps: Optional[int] = None             # annealing steps
    sa_batch: Optional[int] = None             # annealing batch
    seed: Optional[int] = None                 # place/route RNG seed
    split_fifo_ctrl_delay: Optional[float] = None  # split-FIFO ctrl ns
    #: placement engine: "python" host SA / "batched" device chains /
    #: "auto" (tile-count switch); None = caller default
    place_strategy: Optional[str] = None

    def __post_init__(self):
        # canonicalize before freezing semantics: str -> enum, dict/list ->
        # sorted tuples, so equal design points compare and hash equal
        if isinstance(self.sb_type, str):
            object.__setattr__(self, "sb_type", SwitchBoxType(self.sb_type))
        if isinstance(self.extra_layers, dict):
            object.__setattr__(self, "extra_layers", tuple(
                sorted((int(w), int(t))
                       for w, t in self.extra_layers.items())))
        else:
            object.__setattr__(self, "extra_layers", tuple(
                (int(w), int(t)) for w, t in self.extra_layers))
        object.__setattr__(self, "mem_columns",
                           tuple(int(c) for c in self.mem_columns))
        if self.width < 1 or self.height < 1:
            raise ValueError("array dims must be >= 1 tile")
        if self.num_tracks < 1:
            raise ValueError("num_tracks must be >= 1")
        if not 0.0 <= self.reg_density <= 1.0:
            raise ValueError("reg_density must be in [0, 1]")
        for name in ("cb_sides", "sb_sides"):
            if not 1 <= getattr(self, name) <= 4:
                raise ValueError(f"{name} must be in 1..4")
        if self.route_strategy not in _ROUTE_STRATEGIES:
            raise ValueError(
                f"route_strategy must be one of {_ROUTE_STRATEGIES}, "
                f"got {self.route_strategy!r}")
        if self.place_strategy not in _PLACE_STRATEGIES:
            raise ValueError(
                f"place_strategy must be one of {_PLACE_STRATEGIES}, "
                f"got {self.place_strategy!r}")
        if self.alphas is not None:
            object.__setattr__(self, "alphas",
                               tuple(float(a) for a in self.alphas))
            if not self.alphas:
                raise ValueError("alphas must be non-empty when set")
        for name in ("reg_penalty", "split_fifo_ctrl_delay"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, float(v))
        for name in ("sa_steps", "sa_batch", "seed"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, int(v))
        if self.sa_steps is not None and self.sa_steps < 0:
            raise ValueError("sa_steps must be >= 0")
        if self.sa_batch is not None and self.sa_batch < 1:
            raise ValueError("sa_batch must be >= 1")

    # -- derived views --------------------------------------------------------
    def sb_connection_sides(self) -> Tuple[Side, ...]:
        return sides_for(self.sb_sides)

    def cb_connection_sides(self) -> Tuple[Side, ...]:
        return sides_for(self.cb_sides)

    def layers(self) -> Dict[int, int]:
        """bit_width -> num_tracks for every routing layer."""
        out = {self.track_width: self.num_tracks}
        out.update(dict(self.extra_layers))
        return out

    def n_tiles(self) -> int:
        return self.width * self.height

    # -- serialization --------------------------------------------------------
    def to_dict(self) -> Dict[str, object]:
        """JSON-safe field map (enums to values, tuples to lists)."""
        out: Dict[str, object] = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, enum.Enum):
                v = v.value
            elif isinstance(v, tuple):
                v = [list(e) if isinstance(e, tuple) else e for e in v]
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "InterconnectSpec":
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise TypeError(
                f"unknown InterconnectSpec fields {unknown}; "
                f"valid fields: {sorted(known)}")
        return cls(**d)  # type: ignore[arg-type]

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "InterconnectSpec":
        return cls.from_dict(json.loads(s))

    #: fields added after the digest schema was frozen (PR 4): they are
    #: omitted from the canonical JSON while they hold their default, so
    #: growing the spec never drifts the digests of pre-existing design
    #: points (the committed golden fixtures included). Append-only.
    DIGEST_OPTIONAL = ("reg_penalty", "alphas", "sa_steps", "sa_batch",
                       "seed", "split_fifo_ctrl_delay", "place_strategy")

    def canonical_dict(self) -> Dict[str, object]:
        """The digest's view of the spec: :meth:`to_dict` minus any
        ``DIGEST_OPTIONAL`` field still at its default (forward-compatible
        digest schema — new knobs only show up once actually set)."""
        defaults = {f.name: f.default for f in fields(self)}
        d = self.to_dict()
        for name in self.DIGEST_OPTIONAL:
            if getattr(self, name) == defaults[name]:
                d.pop(name, None)
        return d

    def canonical_json(self) -> str:
        return json.dumps(self.canonical_dict(), sort_keys=True,
                          separators=(",", ":"))

    def digest(self) -> str:
        """Stable content address of this design point: sha256 over the
        canonical (sorted-keys, no-whitespace) JSON form. Key-order and
        process independent — the cache key for every spec-addressed
        store (DSE records, golden fixtures, served results)."""
        return hashlib.sha256(self.canonical_json().encode()).hexdigest()

    #: fields that tune *how* a point is evaluated, not what hardware it
    #: is — excluded from hardware_digest() so IR/resources/fabric caches
    #: are shared across e.g. router-strategy comparisons
    EXECUTION_KNOBS = ("route_strategy", "auto_min_tiles",
                       "emulate_io_chunk", "reg_penalty", "alphas",
                       "sa_steps", "sa_batch", "seed",
                       "split_fifo_ctrl_delay", "place_strategy")

    def hardware_spec(self) -> "InterconnectSpec":
        """This spec with the execution knobs cleared: two points that
        compile to identical hardware compare equal."""
        return replace(self, **{k: None for k in self.EXECUTION_KNOBS})

    def hardware_digest(self) -> str:
        """Content address of the *hardware* this spec compiles to
        (execution knobs excluded) — the key for compiled-artifact
        caches. Equals ``digest()`` when no execution knob is set."""
        return self.hardware_spec().digest()

    def replace(self, **overrides) -> "InterconnectSpec":
        """Functional update (the spec itself is frozen)."""
        return replace(self, **overrides)

    def with_execution_defaults(self, **defaults) -> "InterconnectSpec":
        """Fill *unset* (None) execution knobs from ``defaults`` and
        return the resolved spec. This is how the DSE executor pins a
        design point before addressing the persistent result store: the
        resolved digest then fully determines the stored record instead
        of leaking executor state. Knobs the spec already sets win;
        ``None`` defaults are skipped; non-knob names are rejected."""
        unknown = sorted(set(defaults) - set(self.EXECUTION_KNOBS))
        if unknown:
            raise TypeError(f"not execution knobs: {unknown}; "
                            f"knobs: {sorted(self.EXECUTION_KNOBS)}")
        updates = {k: v for k, v in defaults.items()
                   if v is not None and getattr(self, k) is None}
        return replace(self, **updates) if updates else self


def spec_from_kwargs(**kwargs) -> InterconnectSpec:
    """Canonicalize legacy ``create_uniform_interconnect`` keyword
    arguments into an :class:`InterconnectSpec`.

    Rejects non-spec arguments with an actionable error instead of a raw
    ``TypeError`` deep inside caching code: callables (e.g. ``core_fn``)
    are not serializable design-point data and must be passed to the
    compile call instead."""
    for k, v in kwargs.items():
        if callable(v) and not isinstance(v, type):
            raise TypeError(
                f"kwarg {k!r} is a callable and cannot be part of a "
                "design-point spec (it is not serializable/cacheable); "
                "pass it to PassManager.compile(..., core_fn=...) instead")
    return InterconnectSpec.from_dict(dict(kwargs))


def _json_safe(v: object) -> object:
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, tuple):
        return list(v)
    return v


def spec_axes(base: InterconnectSpec,
              axes: Dict[str, Sequence]) -> Dict[str, Tuple]:
    """Canonicalize search/sweep axes over ``base``: every key must be a
    spec field, and every value must produce a constructible spec (bad
    values fail here, with the axis named, instead of deep inside a
    sweep). Values are canonicalized through the spec's own coercion
    (``"wilton"`` -> ``SwitchBoxType.WILTON``, lists -> tuples) and
    deduplicated order-preserving — the axis order is the neighborhood
    order the greedy selector walks."""
    names = {f.name for f in fields(InterconnectSpec)}
    out: Dict[str, Tuple] = {}
    for name, values in axes.items():
        if name not in names:
            raise TypeError(f"unknown spec axis {name!r}; "
                            f"valid fields: {sorted(names)}")
        vals: List = []
        for v in values:
            try:
                canon = getattr(replace(base, **{name: v}), name)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"axis {name!r}: value {v!r} does not produce a "
                    f"valid spec: {e}") from e
            if canon not in vals:
                vals.append(canon)
        if not vals:
            raise ValueError(f"axis {name!r} has no values")
        out[name] = tuple(vals)
    return out


def mutate_spec(spec: InterconnectSpec, axes: Dict[str, Sequence],
                rng) -> InterconnectSpec:
    """Single-axis local mutation: pick one axis (uniformly among those
    with an alternative to the spec's current value) and move it to a
    different allowed value. The mutation primitive behind the greedy
    and evolutionary DSE selectors; returns ``spec`` unchanged when no
    axis offers an alternative (a one-point space)."""
    movable = [n for n in axes
               if any(v != getattr(spec, n) for v in axes[n])]
    if not movable:
        return spec
    name = rng.choice(movable)
    choices = [v for v in axes[name] if v != getattr(spec, name)]
    return replace(spec, **{name: rng.choice(choices)})


def neighbor_specs(spec: InterconnectSpec,
                   axes: Dict[str, Sequence]
                   ) -> List[InterconnectSpec]:
    """The specs one axis step away from ``spec``: for each axis, the
    values adjacent to the current value in the axis's ordered value
    list (every axis value when the current value is off-axis).
    Deterministic order — axis declaration order, lower neighbor first —
    so seeded searches reproduce exactly."""
    out: List[InterconnectSpec] = []
    seen = {spec}
    for name, vals in axes.items():
        cur = getattr(spec, name)
        vals = tuple(vals)
        if cur in vals:
            i = vals.index(cur)
            adj = [vals[j] for j in (i - 1, i + 1) if 0 <= j < len(vals)]
        else:
            adj = list(vals)
        for v in adj:
            cand = replace(spec, **{name: v})
            if cand not in seen:
                seen.add(cand)
                out.append(cand)
    return out


def spec_grid(base: InterconnectSpec,
              axes: Dict[str, Sequence],
              label: Optional[Callable[[InterconnectSpec], Dict]] = None
              ) -> List[Tuple[InterconnectSpec, Dict]]:
    """Declarative sweep grid: the cartesian product of field overrides
    over ``base``. Returns ``(spec, extra)`` points for
    :meth:`repro_torch.core.dse.SweepExecutor.run_points` — ``extra``
    defaults to the JSON-safe values of the varied fields and can be customized
    with ``label`` (a ``spec -> dict`` function)."""
    names = list(axes)
    points: List[Tuple[InterconnectSpec, Dict]] = []
    for combo in itertools.product(*(axes[n] for n in names)):
        s = replace(base, **dict(zip(names, combo)))
        extra = (label(s) if label is not None
                 else {n: _json_safe(getattr(s, n)) for n in names})
        points.append((s, extra))
    return points

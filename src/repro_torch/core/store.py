"""Spec-addressed persistent DSE result store (counterpart of
repro/core/store.py).

Every design point has a canonical content address — ``spec.digest()``
(see :mod:`repro_torch.core.spec`) — and this module makes that address the
key of an on-disk store of PnR/emulation/area records, so results
survive the process that computed them: a repeated sweep, a benchmark
re-run, or a :class:`repro_torch.serve.dse_service.DSEService` query hits the
store instead of re-routing the same hardware (the artifact-reuse
discipline of cached-partition FPGA flows, applied to Canal's DSE).

Layout on disk (one JSON file per digest, atomically replaced)::

    <root>/
      records/<spec_digest>.json        # versioned envelope + record
      by_hardware/<hardware_digest>/<spec_digest>   # secondary index

The ``by_hardware`` index groups execution-knob variants (router
strategy, α sweep, annealing budget, ...) of the same hardware, making
them enumerable via :meth:`ResultStore.for_hardware`.

Durability rules:

* writes are atomic (`os.replace` of a same-directory temp file), so a
  crashed writer can never leave a half-record under the digest path;
* loads are corruption-tolerant: truncated/garbled/wrong-schema files
  count as misses (and are tallied in ``stats()``), never raise;
* the envelope carries a schema version stamp; unknown versions are
  treated as misses so future schema changes stay forward-compatible.

Merge rules (the differing-app-set fix): :meth:`ResultStore.put`
*merges* a record into any existing record for the same digest — app
union, newest-wins per app — instead of whole-record last-writer-wins.
Two executors alternating different app sets against one store used to
overwrite each other's records forever (each saw only the other's apps,
missed, recomputed, and clobbered); now the stored record accumulates
every app ever computed for the digest and both converge on hits.
Writers sharing one ``ResultStore`` object serialize the
read-merge-write; independent processes race last-writer-wins on a
single put but still converge, because every writer merges the other's
apps in before replacing the file.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from typing import Dict, Iterator, List, Optional

from .spec import InterconnectSpec

#: bump when the envelope layout changes incompatibly; readers treat any
#: other version as a miss rather than guessing
SCHEMA_VERSION = 1

#: env var naming the default store root (CI points it at a cached dir).
#: The port's own: a spec digest names no engine, so a store shared with
#: the JAX package would serve one engine's records as the other's.
STORE_ENV = "CANAL_TORCH_RESULT_STORE"

#: default on-disk location when neither an explicit root nor the env
#: var is given (relative to the working directory, like a build cache);
#: the port's own, for the same reason
DEFAULT_ROOT = ".canal_torch_store"

_DIGEST_RE = re.compile(r"^[0-9a-f]{64}$")


def default_store_root() -> str:
    """The store root honoring the ``CANAL_TORCH_RESULT_STORE``
    override."""
    return os.environ.get(STORE_ENV) or DEFAULT_ROOT


def record_metrics(rec: Dict) -> Dict[str, float]:
    """The frontier-relevant summary of a DSE record: the
    (area, critical-path delay, routability) triple the search front end
    (:mod:`repro_torch.core.search`) optimizes over.

    * ``area`` — SB + CB area of the design point;
    * ``critical_path_ns`` — the *worst* critical path over the routed
      apps (``inf`` when nothing routed: an unroutable point can never
      dominate on delay);
    * ``routability`` — routed apps / total apps in the record.

    Records whose app entries carry the routed-scope static metrics
    (``static_ii`` / ``min_slack_ns``, stamped per app by the executor)
    additionally summarize to:

    * ``throughput`` — the *worst* static throughput bound over the
      routed apps, in tokens/cycle (``1 / static_ii``; 0.0 when nothing
      routed or a loop deadlocks);
    * ``min_slack_ns`` — the worst per-net slack over the routed apps
      against the fixed reference clock
      (:data:`repro_torch.core.analysis.DEFAULT_CLOCK_NS`).

    These two appear only when at least one app entry carries the static
    fields, so records written before the routed analyzer keep their
    exact three-key shape.

    Stamped onto records at compute time and re-derived when an app-set
    merge changes the app population, so store consumers (``recommend``,
    external tooling) can rank records without reconstructing the
    aggregation."""
    apps = rec.get("apps") or {}
    routed = [a for a in apps.values()
              if isinstance(a, dict) and a.get("success")]
    crit = float("inf")
    if routed:
        crit = max(float(a.get("critical_path_ns", float("inf")))
                   for a in routed)
    area = float(rec.get("sb_area") or 0.0) + \
        float(rec.get("cb_area") or 0.0)
    metrics = {"area": area, "critical_path_ns": crit,
               "routability": len(routed) / len(apps) if apps else 0.0}
    if any(isinstance(a, dict)
           and ("static_ii" in a or "min_slack_ns" in a)
           for a in apps.values()):
        if routed:
            # worst-case over apps; an app predating the static stamps
            # defaults to the unconstrained values (II=1, slack vs the
            # reference clock) rather than poisoning the aggregate
            from .analysis import DEFAULT_CLOCK_NS
            metrics["throughput"] = min(
                (1.0 / ii if (ii := float(a.get("static_ii", 1.0))) > 0
                 and ii != float("inf") else 0.0)
                for a in routed)
            metrics["min_slack_ns"] = min(
                float(a.get("min_slack_ns",
                            DEFAULT_CLOCK_NS - crit)) for a in routed)
        else:
            metrics["throughput"] = 0.0
            metrics["min_slack_ns"] = float("-inf")
    return metrics


def _stamped_apps(rec: Dict) -> Dict[str, Dict]:
    """Copy a record's app entries with the record-level
    ``emulate_cycles`` claim stamped per app. A merged record holds apps
    produced by writers with *different* emulation contexts, so the
    record-level field alone can no longer vouch for every app — the
    stamp preserves each app's own claim across merges (``None`` marks
    an unknown claim, which emulating readers treat as a miss)."""
    cycles = rec.get("emulate_cycles")
    out: Dict[str, Dict] = {}
    for name, entry in (rec.get("apps") or {}).items():
        if isinstance(entry, dict):
            entry = dict(entry)
            entry.setdefault("emulate_cycles", cycles)
        out[name] = entry
    return out


def merge_records(old: Dict, new: Dict) -> Dict:
    """Merge ``new`` into ``old`` for the same digest: union of apps with
    newest-wins per app; every other field newest-wins wholesale. Both
    sides' app entries get per-app ``emulate_cycles`` stamps (see
    :func:`_stamped_apps`) and the frontier metrics are recomputed over
    the merged app population. Records without a dict app map fall back
    to plain newest-wins."""
    if not isinstance(old.get("apps"), dict) \
            or not isinstance(new.get("apps"), dict):
        return new
    apps = _stamped_apps(old)
    apps.update(_stamped_apps(new))
    merged = dict(new, apps=apps)
    if "metrics" in old or "metrics" in new:
        merged["metrics"] = record_metrics(merged)
    return merged


def atomic_write_json(path: str, payload) -> None:
    """Same-directory temp file + ``os.replace``: readers only ever see
    absent or complete files, even across a writer crash. The shared
    durability idiom for store records and benchmark trajectories."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tmp-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True, default=str)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class ResultStore:
    """Content-addressed persistent map ``spec.digest() -> DSE record``.

    Thread-safe; cheap to construct (directories are created lazily on
    first write, so opening a store never litters the filesystem).
    """

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.abspath(root or default_store_root())
        self._records = os.path.join(self.root, "records")
        self._by_hw = os.path.join(self.root, "by_hardware")
        # re-entrant: put() holds it across its read-merge-write while
        # the envelope load underneath counts corruption under it too
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        self.writes = 0

    # --------------------------------------------------------------- paths
    @staticmethod
    def _check_digest(digest: str) -> str:
        if not isinstance(digest, str) or not _DIGEST_RE.match(digest):
            raise ValueError(f"not a sha256 hex digest: {digest!r}")
        return digest

    def _record_path(self, digest: str) -> str:
        return os.path.join(self._records, f"{digest}.json")

    # --------------------------------------------------------------- reads
    def get(self, key) -> Optional[Dict]:
        """The stored record for ``key`` (a digest string or an
        :class:`InterconnectSpec`), or None on miss. A file that fails to
        parse, carries an unknown schema version, or misrecords its own
        digest is a *miss*, not an error — a corrupted cache must never
        poison or abort a sweep."""
        digest = self._as_digest(key)
        env = self._load_envelope(self._record_path(digest))
        with self._lock:
            if env is None or env.get("spec_digest") != digest:
                if env is not None:
                    self.corrupt += 1
                self.misses += 1
                return None
            self.hits += 1
        return env["record"]

    def _load_envelope(self, path: str) -> Optional[Dict]:
        try:
            with open(path) as f:
                env = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            if os.path.exists(path):
                with self._lock:
                    self.corrupt += 1
            return None
        if (not isinstance(env, dict)
                or env.get("schema") != SCHEMA_VERSION
                or not isinstance(env.get("record"), dict)):
            with self._lock:
                self.corrupt += 1
            return None
        return env

    def __contains__(self, key) -> bool:
        """True iff :meth:`get` would serve a record — a corrupt or
        foreign-schema file under the digest path does not count (mere
        file existence must not talk a caller out of recomputing)."""
        digest = self._as_digest(key)
        env = self._load_envelope(self._record_path(digest))
        return env is not None and env.get("spec_digest") == digest

    def __len__(self) -> int:
        try:
            return sum(1 for _ in self.digests())
        except OSError:
            return 0

    def digests(self) -> Iterator[str]:
        """Every digest with a committed record file (temp files and
        foreign droppings are skipped — only ``<sha256>.json`` counts)."""
        try:
            names = os.listdir(self._records)
        except OSError:
            return
        for name in sorted(names):
            stem, ext = os.path.splitext(name)
            if ext == ".json" and _DIGEST_RE.match(stem):
                yield stem

    def for_hardware(self, key) -> List[Dict]:
        """All stored records whose spec compiles to the given hardware
        (``key``: a ``hardware_digest()`` string or a spec) — the
        execution-knob variants of one design, enumerable e.g. for
        router-strategy or α-sweep comparisons. Corrupt/missing entries
        are skipped."""
        if isinstance(key, InterconnectSpec):
            hw = key.hardware_digest()
        else:
            hw = self._check_digest(key)
        try:
            names = sorted(os.listdir(os.path.join(self._by_hw, hw)))
        except OSError:
            return []
        out = []
        for name in names:
            if _DIGEST_RE.match(name):
                rec = self.get(name)
                if rec is not None:
                    out.append(rec)
        return out

    # -------------------------------------------------------------- writes
    def put(self, spec_or_digest, record: Dict,
            hardware_digest: Optional[str] = None,
            spec_dict: Optional[Dict] = None,
            merge: bool = True) -> str:
        """Persist ``record`` under the design point's content address.

        Pass the :class:`InterconnectSpec` when available — the envelope
        then embeds the spec JSON (the store is self-describing: a record
        can be re-queried or re-verified without the producing process)
        and the hardware index is maintained automatically. With a bare
        digest string, ``hardware_digest``/``spec_dict`` are optional
        extras. Returns the digest written.

        With ``merge`` (the default) an existing record for the same
        digest is *merged into*, not overwritten: app union, newest-wins
        per app (see :func:`merge_records`) — the fix for executors with
        differing app sets ping-ponging overwrites against one store.
        ``merge=False`` restores whole-record replacement (e.g. to purge
        a record known to be stale). The caller's ``record`` dict is
        never mutated — merged app entries are copies."""
        if isinstance(spec_or_digest, InterconnectSpec):
            spec = spec_or_digest
            digest = spec.digest()
            hardware_digest = spec.hardware_digest()
            spec_dict = spec.canonical_dict()
        else:
            digest = self._check_digest(spec_or_digest)
            if hardware_digest is not None:
                self._check_digest(hardware_digest)
        path = self._record_path(digest)
        # the read-merge-write is serialized per store object (cross-
        # process writers race last-writer-wins but still converge: each
        # merges the other's apps in before replacing the file)
        with self._lock:
            if merge:
                old = self._load_envelope(path)
                if old is not None and old.get("spec_digest") == digest:
                    record = merge_records(old["record"], record)
            env = {"schema": SCHEMA_VERSION, "spec_digest": digest,
                   "hardware_digest": hardware_digest, "spec": spec_dict,
                   "record": record}
            os.makedirs(self._records, exist_ok=True)
            # index marker first: a crash between the two steps then
            # leaves a dangling marker (for_hardware skips it — get()
            # misses), never a committed record the index can't
            # enumerate; unconditional create also avoids the
            # exists-then-open race between writers
            if hardware_digest is not None:
                hw_dir = os.path.join(self._by_hw, hardware_digest)
                os.makedirs(hw_dir, exist_ok=True)
                with open(os.path.join(hw_dir, digest), "w"):
                    pass
            atomic_write_json(path, env)
            self.writes += 1
        return digest

    # --------------------------------------------------------------- misc
    @staticmethod
    def _as_digest(key) -> str:
        if isinstance(key, InterconnectSpec):
            return key.digest()
        return ResultStore._check_digest(key)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"root": self.root, "records": len(self),
                    "hits": self.hits, "misses": self.misses,
                    "corrupt": self.corrupt, "writes": self.writes}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"ResultStore({self.root!r}, records={len(self)})"

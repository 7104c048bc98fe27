"""Design-space exploration harness (§4.2), in PyTorch (counterpart of
repro/core/dse.py).

One function per DSE axis from the paper: switch-box topology, number of
routing tracks, and SB/CB core-port connections — plus the FIFO study of
§4.1. Each returns a list of records consumed by the figure benchmarks and
the tests.

All sweeps run on a shared :class:`SweepExecutor`, the bulk-evaluation
engine behind the paper's "fast design space exploration" claim: it caches
``RoutingResources``/``FabricModule`` per interconnect, evaluates
independent design points concurrently, and emulates every routed app of a
design point as one batched ``FabricModule.run_batch`` loop — the fused
batched CUDA kernel (PE cores evaluated in-kernel, per-app depth
masking) when ``use_kernels=True``. PnR's device stages and emulation
run on ``device`` (``None``: the CUDA card); with several visible cards
each batch splits across them (``shard=None``/``True``), or each card
gets its own emulation queue (``shard=False``). Records have the
reference's shape, field for field; the port keeps its own store root
(:mod:`repro_torch.core.store`).

Design points are :class:`repro_torch.core.spec.InterconnectSpec` objects
(legacy kwargs dicts are canonicalized into specs on entry), and every
executor
cache — interconnect, routing resources, lowered fabric — is keyed on
``spec.hardware_digest()``: a serialization-stable content address of the
hardware (execution knobs excluded, so e.g. router-strategy comparisons
share compiled artifacts), instead of the old raw-kwargs tuples that broke
on callables and nested values; records carry the full ``spec.digest()``.
The ``sweep_*`` functions are declarative grids (``spec_grid``) over the
one generic driver, :meth:`SweepExecutor.run_points`.

Host PnR and device emulation are *pipelined*: with
``pipeline_emulation=True`` (default) a design point's emulation batch is
dispatched asynchronously to a per-device emulation queue the moment its
routes are ready, so the router works on the next point while the fabric
of the previous one is still sweeping on device; the emulation futures
are joined before records are returned/persisted.
"""
from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import Span, current, span

from .area import connection_box_area, switch_box_area
from .pnr import place_and_route
from .pnr.app import BENCH_APPS
from .spec import (InterconnectSpec, SwitchBoxType, spec_from_kwargs,
                   spec_grid)
from .store import STORE_ENV, ResultStore, record_metrics

def _as_spec(point) -> InterconnectSpec:
    """Canonicalize a design point: an InterconnectSpec passes through, a
    legacy kwargs dict is converted (rejecting non-serializable values
    such as callables with an actionable error)."""
    if isinstance(point, InterconnectSpec):
        return point
    if isinstance(point, dict):
        return spec_from_kwargs(**point)
    raise TypeError(
        f"design point must be an InterconnectSpec or a kwargs dict, "
        f"got {type(point).__name__}")


#: PnR knobs a design point's spec may leave unset, with the defaults
#: :meth:`SweepExecutor.resolve` pins them to (the reference executor's).
_PNR_DEFAULTS: Dict[str, Any] = {
    "sa_steps": 60, "sa_batch": 16, "alphas": (2.0,),
    "split_fifo_ctrl_delay": 0.0, "seed": 0, "reg_penalty": 4.0,
}


class SweepExecutor:
    """Reusable bulk design-point evaluator.

    One executor serves many sweeps: per-interconnect caches are shared
    across design points (``RoutingResources`` for the router,
    ``FabricModule`` for emulation), independent points run concurrently on
    a thread pool (PyTorch releases the GIL in its kernels), and all
    routed apps of a point are emulated as a single batch. Records
    accumulate on the executor and can be persisted as JSON for
    ``benchmarks/run.py``.
    """

    def __init__(self, apps: Optional[Dict[str, Callable]] = None,
                 max_workers: Optional[int] = None,
                 emulate_cycles: int = 0, use_kernels: bool = True,
                 shard: Optional[bool] = None,
                 route_strategy: str = "auto",
                 place_strategy: str = "auto",
                 pipeline_emulation: bool = True,
                 io_chunk: Optional[int] = None,
                 store: Any = None, device: DeviceLike = None):
        self.apps = apps or BENCH_APPS
        #: where PnR's device stages and emulation run (None: the card)
        self.device = resolve_device(device)
        self.max_workers = max_workers
        self.emulate_cycles = emulate_cycles
        self.use_kernels = use_kernels
        self.shard = shard
        #: router engine (repro_torch.core.pnr.route): "auto" routes big
        #: fabrics with the device-batched min-plus lower bounds
        self.route_strategy = route_strategy
        #: placement engine (repro_torch.core.pnr.detailed_place): "auto"
        #: anneals big fabrics with the device-resident parallel-tempering
        #: chains
        self.place_strategy = place_strategy
        self.pipeline_emulation = pipeline_emulation
        #: ext-IO streaming chunk for long stimulus traces (HBM-gridded
        #: fused kernel); None keeps the per-cycle scan
        self.io_chunk = io_chunk
        #: persistent spec-addressed result store: a ResultStore, a root
        #: path, False (disable even if the env names a store), or None —
        #: attach the CANAL_TORCH_RESULT_STORE store when the env var is
        #: set
        self.store = self._open_store(store)
        self._lock = threading.Lock()
        self._ic_cache: Dict[Tuple, Any] = {}
        self._res_cache: Dict[Tuple, Any] = {}
        self._fab_cache: Dict[Tuple, Any] = {}
        self._inflight: Dict[str, Future] = {}
        self._emu_pool: Optional[ThreadPoolExecutor] = None
        self._emu_devices: List[Any] = []
        self._emu_rr = 0
        self._active_runs = 0
        self._pending: List[Future] = []
        self.records: List[Dict] = []
        #: observability counters for the store-backed execution path
        self.store_hits = 0      # records served from the store
        self.store_misses = 0    # store consulted, nothing usable
        self.coalesced = 0       # requests piggybacked on an in-flight one
        self.pnr_computations = 0  # design points actually placed+routed
        #: design points rejected by the static pre-screen (PnR skipped);
        #: one per *computed* rejection — store hits on a rejected record
        #: count as store_hits, not here
        self.analysis_rejections = 0
        #: stored records refused because their analysis verdict was
        #: produced by a different rule set (see :meth:`record_usable`);
        #: each one re-analyzes (and re-routes) instead of serving stale
        self.stale_rule_set = 0
        self._analysis_cache: Dict[Tuple, Any] = {}

    @staticmethod
    def _open_store(store) -> Optional[ResultStore]:
        if store is False:
            return None
        if store is None:
            root = os.environ.get(STORE_ENV)
            return ResultStore(root) if root else None
        if isinstance(store, ResultStore):
            return store
        return ResultStore(str(store))

    # ------------------------------------------------------------- caches
    @staticmethod
    def _key(point) -> Tuple:
        """Canonical cache key for a design point (a spec, or a kwargs
        dict canonicalized into one by :func:`_as_spec`).

        Keys on ``spec.hardware_digest()`` — stable across processes,
        key orderings and value spellings, and shared across points that
        differ only in execution knobs (route strategy etc.), since the
        cached artifacts (IR, routing resources, lowered fabric) depend
        only on the hardware. Callables and unknown kwargs are rejected
        with an actionable error instead of the old silent ``str(fn)``
        key (whose embedded ``0x...`` id changed every run) or a raw
        ``TypeError``."""
        return ("spec", _as_spec(point).hardware_digest())

    def interconnect(self, spec=None, **ic_kwargs):
        """The per-executor interconnect cache, keyed on the design
        point's ``spec.hardware_digest()``. Accepts a spec positionally
        or legacy generator kwargs.

        The cached entry is compiled from ``spec.hardware_spec()`` —
        execution knobs cleared — because it is shared across every
        knob variant of the same hardware: the IR's own stamped identity
        (``ic.params["spec_digest"]``, ``ic.spec``) must describe what
        all of them have in common, not whichever variant got compiled
        first."""
        if spec is not None and ic_kwargs:
            raise TypeError("pass either a spec or kwargs, not both")
        spec = _as_spec(spec if spec is not None else ic_kwargs)
        key = self._key(spec)
        with self._lock:
            ic = self._ic_cache.get(key)
        if ic is None:
            from .passes import PassManager
            ic = PassManager().run(spec.hardware_spec())
            with self._lock:
                ic = self._ic_cache.setdefault(key, ic)
        return ic

    def analysis_report(self, spec, ic=None):
        """Static-analysis report for a design point, cached per
        hardware digest (analysis reads only the hardware IR, so every
        execution-knob variant shares one verdict). This is the DSE
        pre-screen: ``_compute_point`` consults it before spending a PnR
        run on a statically-invalid fabric."""
        from .analysis import analyze
        spec = _as_spec(spec)
        key = self._key(spec)
        with self._lock:
            report = self._analysis_cache.get(key)
        if report is None:
            if ic is None:
                ic = self.interconnect(spec)
            report = analyze(ic, spec=spec.hardware_spec())
            with self._lock:
                report = self._analysis_cache.setdefault(key, report)
        return report

    def resources(self, ic, key: Tuple,
                  reg_penalty: Optional[float] = None):
        """Shared ``RoutingResources`` (adjacency, base costs, coarse
        graph), keyed on ``(interconnect, reg_penalty)`` — a penalty
        change must not hand back arrays priced for a different one (the
        old per-interconnect key silently would have)."""
        from .pnr.route import RoutingResources
        rp = (_PNR_DEFAULTS["reg_penalty"] if reg_penalty is None
              else reg_penalty)
        ckey = (key, float(rp))
        with self._lock:
            res = self._res_cache.get(ckey)
        if res is None:
            res = RoutingResources(ic, reg_penalty=rp, device=self.device)
            with self._lock:
                res = self._res_cache.setdefault(ckey, res)
        return res

    def fabric(self, ic, key: Tuple, device: DeviceLike = None):
        """The lowered fabric of ``ic`` on ``device`` (default: this
        executor's), cached per (hardware, device)."""
        from .lowering import compile_interconnect
        dev = self.device if device is None else torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        ckey = (key, str(dev))
        with self._lock:
            fab = self._fab_cache.get(ckey)
        if fab is None:
            fab = compile_interconnect(ic, device=dev,
                                       use_kernels=self.use_kernels)
            with self._lock:
                fab = self._fab_cache.setdefault(ckey, fab)
        return fab

    # ----------------------------------------------------- emulation queue
    def _emu_queue(self) -> Tuple[ThreadPoolExecutor, Any]:
        """Lazily build the per-device emulation queue and pick the next
        device round-robin. The devices are every visible CUDA card (this
        executor's device when it is the CPU). With the batch split
        active (``shard=None`` and more than one card, or ``shard=True``)
        a single queue feeds ``run_batch``, which already spans every
        card; otherwise each card gets its own dispatch thread and points
        are distributed across them."""
        with self._lock:
            if self._emu_pool is None:
                devs = ([torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
                        if self.device.type == "cuda" else [self.device])
                use_shard = ((len(devs) > 1) if self.shard is None
                             else self.shard)
                self._emu_devices = ([None] if use_shard and len(devs) > 1
                                     else devs)
                self._emu_pool = ThreadPoolExecutor(
                    max_workers=len(self._emu_devices),
                    thread_name_prefix="dse-emu")
            dev = self._emu_devices[self._emu_rr % len(self._emu_devices)]
            self._emu_rr += 1
        return self._emu_pool, dev

    def _submit_emulation(self, ic, key: Tuple,
                          routed: List[Tuple[str, Any, Any]],
                          out: Dict[str, Dict],
                          io_chunk: Optional[int] = None,
                          on_done: Optional[Callable[[], None]] = None,
                          pending: Optional[List[Future]] = None
                          ) -> Future:
        """Dispatch one design point's emulation batch asynchronously; the
        returned future merges the report into ``out`` when done (then
        runs ``on_done`` — the store write-back hook, so a record is only
        persisted once complete). Router threads keep running while the
        device sweeps. The future is registered on the global pending
        list (join-all via :meth:`join_pending`/:meth:`save_json`) and,
        when ``pending`` is given, on that per-run list too — so a sweep
        joins exactly its own batches even when several sweeps share the
        executor. The batch runs on the queue's device, on the fabric of
        ``ic`` lowered there."""
        pool, dev = self._emu_queue()
        parent = current()

        def work():
            emu = self._emulate_batch(ic, key, routed, device=dev,
                                      shard=(False if dev is not None
                                             else self.shard),
                                      io_chunk=io_chunk, parent=parent)
            for name, info in emu.items():
                out[name]["emulation"] = info
            if on_done is not None:
                on_done()

        fut = pool.submit(work)
        with self._lock:
            self._pending.append(fut)
            if pending is not None:
                pending.append(fut)
        return fut

    def join_pending(self, pending: Optional[List[Future]] = None) -> None:
        """Block until dispatched emulation batches have merged their
        reports (re-raising the first worker error), then release the
        queue threads — the pool is rebuilt lazily on the next dispatch,
        so repeated sweeps don't accumulate idle workers.

        With ``pending`` (the per-run list a ``run_points`` call threaded
        through its dispatches) only *that run's* futures are joined —
        a concurrent sweep on the same executor keeps ownership of its
        own batches, and its records can never be returned with their
        emulation still in flight. Joined futures are also retired from
        the global list. Without ``pending`` this is a join-*all*
        barrier over every outstanding future (the ``save_json`` /
        close-style drain).

        The pool is only torn down while no ``run_points`` call is
        active: a concurrent sweep must never have its dispatch land on
        a pool another sweep just shut down."""
        source = self._pending if pending is None else pending
        try:
            while True:
                with self._lock:
                    if not source:
                        break
                    fut = source.pop()
                try:
                    # the wait names the card's idle time on this thread:
                    # the profiler does not see the emulation's thread
                    with span("dse.join"):
                        fut.result()
                finally:
                    if pending is not None:
                        with self._lock:
                            try:
                                self._pending.remove(fut)
                            except ValueError:
                                pass
        finally:
            with self._lock:
                idle = self._active_runs == 0
                pool = self._emu_pool if idle else None
                if idle:
                    self._emu_pool = None
            if pool is not None:
                pool.shutdown(wait=True)

    # ----------------------------------------------------- point execution
    def _emulate_batch(self, ic, key: Tuple,
                       routed: List[Tuple[str, Any, Any]],
                       device: DeviceLike = None,
                       shard: Optional[bool] = None,
                       io_chunk: Optional[int] = None,
                       parent: Optional[Span] = None) -> Dict[str, Dict]:
        """Emulate all routed apps of one design point as a single batch.

        ``routed``: (name, packed, PnRResult) triples on ``ic``. Drives a
        common counter stimulus on every app input and records the output
        checksum — the bulk validation pass of the batched DSE engine.
        The batch runs on the fabric of ``ic`` lowered on ``device``
        (default: this executor's; the per-device emulation queues of the
        async pipeline name their card); ``shard`` forwards to
        ``run_batch``. ``parent``: the design point's span, when the batch
        runs on the emulation queue's thread.
        """
        import numpy as np
        from repro_torch.fabric import AppEmulator, run_apps_batch

        with span("dse.emulate", parent=parent, apps=len(routed),
                  cycles=self.emulate_cycles):
            fab = self.fabric(ic, key, device)
            if io_chunk is None:
                io_chunk = self.io_chunk
            emulators, inputs, names = [], [], []
            T = self.emulate_cycles
            for name, packed, result in routed:
                emu = AppEmulator.from_pnr(fab, packed, result)
                ins = {}
                for inst_name, inst in packed.placeable.items():
                    if inst.kind == "io_in":
                        coord = result.placement[inst_name]
                        ins[coord] = np.arange(1, T + 1, dtype=np.int32)
                emulators.append(emu)
                inputs.append(ins)
                names.append(name)
            if fab.device.type == "cuda":
                with torch.cuda.device(fab.device):
                    outs = run_apps_batch(emulators, inputs, T, shard=shard,
                                          io_chunk=io_chunk)
            else:
                outs = run_apps_batch(emulators, inputs, T, shard=shard,
                                      io_chunk=io_chunk)
            report: Dict[str, Dict] = {}
            for name, emu, out in zip(names, emulators, outs):
                checksum = int(sum(int(np.asarray(v, np.int64).sum())
                                   for v in out.values()) & 0xFFFFFFFF)
                report[name] = {"depth": emu.depth, "cycles": T,
                                "out_checksum": checksum}
            return report

    # -------------------------------------------------- store-backed flow
    def resolve(self, point) -> InterconnectSpec:
        """Pin a design point for execution: fill every PnR knob the spec
        leaves unset with this executor's default. The resolved spec's
        ``digest()`` fully determines the resulting record — it is the
        address in the persistent :class:`ResultStore` (its
        ``hardware_digest()`` is unchanged, so compiled-artifact caches
        still pool across knob variants)."""
        return _as_spec(point).with_execution_defaults(
            route_strategy=self.route_strategy,
            place_strategy=self.place_strategy,
            **_PNR_DEFAULTS)

    def record_usable(self, rec: Dict) -> bool:
        """Whether a stored record covers this executor's workload: a
        *superset* of this executor's app set (``ResultStore.put`` merges
        app maps, so a shared store accumulates the union — the lookup
        serves a filtered view matching ``self.apps``), and at least the
        requested emulation per app — an app emulated for ``>=`` the
        requested cycles is covered (its ``emulation`` entry then
        reflects the longer stored run), so executors with differing
        ``emulate_cycles`` sharing one store converge on the deepest
        record instead of thrashing overwrites. Merged records stamp
        ``emulate_cycles`` per app entry; unmerged ones fall back to the
        record-level field, and an app with no cycle claim at all cannot
        serve an emulating executor. The single definition of a store
        *hit* — the serving layer delegates here.

        App identity is *by name*: the store trusts that one app name
        denotes one workload. Distinct workloads registered under the
        same name against a shared store would silently serve each
        other's records — give them distinct names (or stores)."""
        apps = rec.get("apps")
        if not isinstance(apps, dict) or not set(self.apps) <= set(apps):
            return False
        # analysis verdicts are only as good as the rule set that
        # produced them: a record stamped by an older (or no) rule set
        # must re-analyze, not serve a stale clean/rejected verdict.
        # Records with no analysis dict at all predate the analyzer and
        # carry no verdict to go stale.
        analysis = rec.get("analysis")
        if isinstance(analysis, dict):
            from .analysis import rule_set_version
            if analysis.get("rule_set") != rule_set_version():
                with self._lock:
                    self.stale_rule_set += 1
                return False
        if self.emulate_cycles == 0:
            return True
        rec_cycles = rec.get("emulate_cycles")
        for name in self.apps:
            entry = apps[name]
            stored = entry.get("emulate_cycles", rec_cycles) \
                if isinstance(entry, dict) else rec_cycles
            if not (isinstance(stored, int)
                    and stored >= self.emulate_cycles):
                return False
        return True

    def _store_lookup(self, digest: str) -> Optional[Dict]:
        """Consult the store; unusable records (see :meth:`record_usable`)
        are misses and get recomputed + merged in. A usable record whose
        merged app map is a *strict* superset of this executor's apps is
        served as a filtered view (only ``self.apps`` entries, metrics
        recomputed over that view) so sweep consumers see the shape they
        asked for."""
        if self.store is None:
            return None
        rec = self.store.get(digest)
        usable = rec is not None and self.record_usable(rec)
        with self._lock:
            if usable:
                self.store_hits += 1
            else:
                self.store_misses += 1
        if not usable:
            return None
        if set(rec["apps"]) != set(self.apps):
            rec = dict(rec, apps={name: rec["apps"][name]
                                  for name in self.apps})
            rec["metrics"] = record_metrics(rec)
        return rec

    def probe(self, digest: str) -> Optional[Dict]:
        """Public single store probe for a resolved digest: the usable
        record, or None (counted as exactly one store hit or miss). The
        serving layer's cold-point path probes here once and threads the
        verdict into ``run_points(..., assume_cold=True)`` — each cold
        point hits the store exactly once instead of probing again
        inside ``run_point``."""
        return self._store_lookup(digest)

    def _store_put(self, spec: InterconnectSpec, rec: Dict) -> None:
        if self.store is not None:
            self.store.put(spec, rec)

    def run_point(self, point,
                  extra: Optional[Dict] = None,
                  defer_emulation: bool = False,
                  pending: Optional[List[Future]] = None,
                  assume_cold: bool = False) -> Dict:
        """One design point -> one sweep record, store-backed.

        ``point`` is an :class:`InterconnectSpec` (or a legacy kwargs
        dict, canonicalized into one); unset spec knobs resolve against
        the executor defaults (:meth:`resolve`). The resolved digest is
        consulted in the persistent store first (a hit skips PnR and
        emulation entirely); concurrent requests for the same digest
        coalesce onto one in-flight computation; completed records are
        written back to the store.

        ``defer_emulation`` dispatches the emulation batch to the async
        per-device queue instead of running it inline; the record's
        ``emulation`` entries appear once the future lands, and the
        store write-back rides on that future. ``pending`` is the
        caller's per-run future list: the dispatched batch — or, for a
        coalesced request, the leader's batch — is registered there so
        ``join_pending(pending)`` waits on exactly the futures this
        run's records depend on (callers without a list join-all via
        bare :meth:`join_pending`).

        ``assume_cold=True`` skips the leader's store probe: the caller
        asserts it already probed this point's digest (via
        :meth:`probe`) and missed — the single-probe contract of the
        serving layer. Coalescing still applies, so a concurrent
        same-digest computation is joined, not repeated."""
        # count as an active run for the whole body: the emulation-queue
        # teardown in join_pending must not shut down a pool this call
        # is about to dispatch on — direct deferred run_point calls need
        # the same protection run_points gets
        with self._lock:
            self._active_runs += 1
        try:
            return self._run_point(point, extra, defer_emulation, pending,
                                   assume_cold)
        finally:
            with self._lock:
                self._active_runs -= 1

    def _run_point(self, point, extra: Optional[Dict],
                   defer_emulation: bool,
                   pending: Optional[List[Future]],
                   assume_cold: bool = False) -> Dict:
        spec = self.resolve(point)
        digest = spec.digest()
        with self._lock:
            leader = digest not in self._inflight
            if leader:
                fut = self._inflight[digest] = Future()
            else:
                fut = self._inflight[digest]
        if not leader:
            # in-flight futures resolve to (record, emulation-future):
            # a follower's record may still be awaiting the leader's
            # deferred emulation merge, so the follower must adopt that
            # future into its own run's pending list
            rec, emu_fut = fut.result()
            with self._lock:
                self.coalesced += 1
                if (emu_fut is not None and pending is not None
                        and emu_fut not in pending):
                    pending.append(emu_fut)
            return self._finish_record(rec, extra)
        try:
            emu_fut = None
            rec = None if assume_cold else self._store_lookup(digest)
            if rec is None:
                with span("dse.point", trace=digest):
                    rec, emu_fut = self._compute_point(
                        spec, digest, defer_emulation, pending)
            fut.set_result((rec, emu_fut))
        except BaseException as e:
            fut.set_exception(e)
            with self._lock:
                self._inflight.pop(digest, None)
            raise
        if emu_fut is None:
            with self._lock:
                self._inflight.pop(digest, None)
        else:
            # keep the in-flight entry alive until the deferred emulation
            # has merged and the store write-back has landed: a same-digest
            # request arriving in that tail coalesces onto this record
            # instead of missing the store and redoing PnR + emulation
            def _retire(_done, d=digest, f=fut):
                with self._lock:
                    if self._inflight.get(d) is f:
                        del self._inflight[d]
            emu_fut.add_done_callback(_retire)
        return self._finish_record(rec, extra)

    @staticmethod
    def _finish_record(rec: Dict, extra: Optional[Dict]) -> Dict:
        """Per-caller view of a (possibly shared) record: sweep labels
        (``extra``) merge into a shallow copy, so one stored record can
        serve grids that label it differently. Nested app dicts stay
        shared — a deferred emulation merge lands in every view."""
        out = dict(extra or {})
        out.update(rec)
        return out

    def _compute_point(self, spec: InterconnectSpec, digest: str,
                       defer_emulation: bool,
                       pending: Optional[List[Future]] = None
                       ) -> Tuple[Dict, Optional[Future]]:
        """The actual PnR + emulation work for a store miss. All PnR
        knobs come off the resolved ``spec`` — the digest is the whole
        story of how this record was produced. Returns the record plus
        the deferred emulation future (None when emulation ran inline
        or there was nothing to emulate) so coalesced followers can wait
        on it too."""
        t0 = time.perf_counter()
        ic = self.interconnect(spec)
        key = self._key(spec)
        # static pre-screen: a fabric the analyzer rejects gets a record
        # (the verdict persists — re-sweeps hit the store, not PnR) but
        # no PnR/emulation minutes. Free pruning for machine-generated
        # spec streams, where malformed points are routine.
        from .analysis import rule_set_version
        with span("dse.analysis"):
            report = self.analysis_report(spec, ic)
        analysis = report.to_dict(max_diagnostics=16)
        # verdict provenance: which rule set judged this record (see
        # record_usable — a stamp mismatch makes the record unusable)
        analysis["rule_set"] = rule_set_version()
        if not report.ok():
            with self._lock:
                self.analysis_rejections += 1
            msg = ("static analysis rejected the fabric: "
                   + ", ".join(sorted({d.rule for d in report.errors})))
            out = {name: {"success": False,
                          "skipped": "static-analysis",
                          "critical_path_ns": float("inf"),
                          "wirelength": 0, "route_iterations": 0,
                          "seconds": 0.0, "error": msg,
                          "route_strategy": None,
                          "place_strategy": None}
                   for name in self.apps}
            rec = {"spec_digest": digest,
                   "hardware_digest": spec.hardware_digest(),
                   "apps": out, "analysis": analysis,
                   "sb_area": switch_box_area(ic),
                   "cb_area": connection_box_area(ic),
                   "emulate_cycles": self.emulate_cycles,
                   "gen_pnr_seconds": time.perf_counter() - t0}
            rec["metrics"] = record_metrics(rec)
            self._store_put(spec, rec)
            return rec, None
        with self._lock:
            self.pnr_computations += 1
        res = self.resources(ic, key, reg_penalty=spec.reg_penalty)
        out: Dict[str, Dict] = {}
        routed: List[Tuple[str, Any, Any]] = []
        for name, mk in self.apps.items():
            app = mk()
            r = place_and_route(
                ic, app, alphas=spec.alphas, sa_steps=spec.sa_steps,
                sa_batch=spec.sa_batch, resources=res, seed=spec.seed,
                split_fifo_ctrl_delay=spec.split_fifo_ctrl_delay,
                route_strategy=spec.route_strategy,
                auto_min_tiles=spec.auto_min_tiles,
                place_strategy=spec.place_strategy, device=self.device)
            out[name] = {
                "success": r.success,
                "critical_path_ns": r.timing.get("critical_path_ns",
                                                 float("inf")),
                "wirelength": r.wirelength,
                "route_iterations": r.route_iterations,
                "seconds": r.seconds,
                "error": r.error,
                # resolved engines ("auto" calibration data, ROADMAP item)
                "route_strategy": r.route_strategy,
                "place_strategy": r.place_strategy,
            }
            if r.success:
                # routed-scope verdict + static metrics persist per app
                # (inside the app entry, so they survive store merges —
                # merge_records unions apps and recomputes record-level
                # metrics from the merged population)
                from .analysis import analyze as run_rules
                from .analysis import routed_static_metrics
                with span("dse.routed_analysis", app=name):
                    routed_rep = run_rules(ic, spec=spec.hardware_spec(),
                                           scope="routed", pnr=r)
                    out[name]["routed_analysis"] = routed_rep.to_dict(
                        max_diagnostics=4)
                    out[name].update(routed_static_metrics(
                        r.packed, r.routing, r.placement))
            if r.success and self.emulate_cycles:
                routed.append((name, r.packed, r))
        rec: Dict = {"spec_digest": digest,
                     "hardware_digest": spec.hardware_digest(),
                     "apps": out,
                     "analysis": analysis,
                     "sb_area": switch_box_area(ic),
                     "cb_area": connection_box_area(ic),
                     "emulate_cycles": self.emulate_cycles}
        if routed and not defer_emulation:
            emu = self._emulate_batch(
                ic, key, routed, shard=self.shard,
                io_chunk=spec.emulate_io_chunk or self.io_chunk)
            for name, info in emu.items():
                out[name]["emulation"] = info
        # wall time includes interconnect generation (cache misses pay it,
        # cache hits legitimately report the shared-cache speedup); with
        # deferred emulation it covers host PnR only — emulation overlaps
        rec["gen_pnr_seconds"] = time.perf_counter() - t0
        # frontier-relevant scalars (area / critical path / routability)
        # persist on the record so search and serving consumers never
        # re-derive them from the app map
        rec["metrics"] = record_metrics(rec)
        emu_fut = None
        if routed and defer_emulation:
            # persist only once the emulation report has merged — the
            # store must never serve a half-built record
            emu_fut = self._submit_emulation(
                ic, key, routed, out,
                io_chunk=spec.emulate_io_chunk or self.io_chunk,
                on_done=lambda: self._store_put(spec, rec),
                pending=pending)
        else:
            self._store_put(spec, rec)
        return rec, emu_fut

    def run_points(self, points: Sequence[Tuple[Any, Dict]],
                   record: bool = True,
                   assume_cold: bool = False) -> List[Dict]:
        """The generic sweep driver: evaluate ``(point, extra)`` design
        points — points are :class:`InterconnectSpec` objects (see
        :func:`repro_torch.core.spec.spec_grid` for declarative grids) or
        legacy kwargs dicts — concurrently when the pool has more than
        one worker. Order of records matches ``points``.

        With ``pipeline_emulation`` the device emulation of point k runs
        under the host PnR of point k+1 (async dispatch); every emulation
        future *this run* dispatched (or coalesced onto) is joined before
        the records are returned — ownership is per run, so concurrent
        ``run_points`` calls on one executor never steal each other's
        joins or return records with emulation still in flight.

        ``record=False`` skips the ``self.records`` accumulator (the
        :meth:`save_json` batch workflow) — long-lived callers like the
        serving layer would otherwise grow it without bound.
        ``assume_cold=True`` is the serving layer's single-probe path:
        the caller already probed every point's digest and missed, so
        leaders skip the redundant second probe (see :meth:`run_point`).
        """
        workers = self.max_workers
        if workers is None:
            workers = min(len(points), os.cpu_count() or 1, 4)
        defer = self.pipeline_emulation and self.emulate_cycles > 0
        pending: List[Future] = []
        with self._lock:
            self._active_runs += 1
        try:
            if workers <= 1 or len(points) <= 1:
                recs = [self.run_point(kw, extra, defer_emulation=defer,
                                       pending=pending,
                                       assume_cold=assume_cold)
                        for kw, extra in points]
            else:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    futs = [pool.submit(self.run_point, kw, extra, defer,
                                        pending, assume_cold)
                            for kw, extra in points]
                    recs = [f.result() for f in futs]
        finally:
            with self._lock:
                self._active_runs -= 1
            self.join_pending(pending)
        if record:
            self.records.extend(recs)
        return recs

    def run_specs(self, specs: Sequence[Any], record: bool = False,
                  assume_cold: bool = False) -> List[Dict]:
        """Batch-evaluate bare specs (no per-point ``extra`` labels) —
        the search driver's hook: one :meth:`run_points` call per
        candidate batch, store-memoized, ``record=False`` by default so
        adaptive query streams don't grow the accumulator."""
        return self.run_points([(s, {}) for s in specs], record=record,
                               assume_cold=assume_cold)

    def stats(self) -> Dict[str, int]:
        """Snapshot of the store/compute observability counters."""
        with self._lock:
            return {"store_hits": self.store_hits,
                    "store_misses": self.store_misses,
                    "coalesced": self.coalesced,
                    "pnr_computations": self.pnr_computations,
                    "analysis_rejections": self.analysis_rejections,
                    "stale_rule_set": self.stale_rule_set}

    @staticmethod
    def _record_key(rec: Dict) -> Tuple:
        """Dedup identity of a sweep record: the resolved spec digest
        (which pins every PnR knob — α sweep included) plus the app set.
        Records predating the digest field fall back to object identity
        so nothing is silently merged."""
        digest = rec.get("spec_digest")
        if digest is None:
            return ("id", id(rec))
        return (digest, tuple(sorted(rec.get("apps", {}))))

    def dedup_records(self) -> List[Dict]:
        """Accumulated records with repeats collapsed: repeated
        ``sweep_*`` calls on one executor re-deliver the same design
        point (now often straight from the store); only the newest record
        per ``(spec_digest, apps)`` survives, at its first position."""
        out: List[Dict] = []
        pos: Dict[Tuple, int] = {}
        for rec in self.records:
            k = self._record_key(rec)
            if k in pos:
                out[pos[k]] = rec
            else:
                pos[k] = len(out)
                out.append(rec)
        return out

    def save_json(self, path: str) -> str:
        """Persist accumulated records (consumed by benchmarks/run.py),
        deduplicated (:meth:`dedup_records` — repeated sweeps no longer
        re-persist overlapping records). Joins any still-pending
        emulation futures first."""
        self.join_pending()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.dedup_records(), f, indent=2, default=str)
        return path


def _executor_for(executor: Optional[SweepExecutor],
                  apps: Optional[Dict[str, Callable]]) -> SweepExecutor:
    """Shared-executor plumbing for the sweep functions: a passed executor
    carries its own apps, so a per-call override would be silently
    dropped — reject the ambiguous combination instead."""
    if executor is not None:
        if apps is not None:
            raise ValueError(
                "pass apps on the SweepExecutor, not alongside it")
        return executor
    return SweepExecutor(apps=apps)


def fifo_area_study(num_tracks: int = 5, track_width: int = 16
                    ) -> List[Dict]:
    """§4.1 / Fig. 8: static baseline vs full-FIFO vs split-FIFO SB area."""
    from .passes import PassManager
    ic = PassManager().run(InterconnectSpec(
        width=8, height=8, num_tracks=num_tracks, track_width=track_width,
        sb_type=SwitchBoxType.WILTON, reg_density=1.0))
    base = switch_box_area(ic)
    recs = [{"design": "static_baseline", "sb_area": base, "overhead": 0.0}]
    for mode in ("full", "split"):
        a = switch_box_area(ic, rv=mode)
        recs.append({"design": f"fifo_{mode}", "sb_area": a,
                     "overhead": a / base - 1.0})
    return recs


def sweep_num_tracks(tracks: Sequence[int] = (2, 3, 4, 5, 6),
                     apps: Optional[Dict[str, Callable]] = None,
                     width: int = 8, height: int = 8,
                     track_fc: float = 1.0,
                     executor: Optional[SweepExecutor] = None
                     ) -> List[Dict]:
    """§4.2.1 / Figs. 10–11: SB/CB area and application runtime vs tracks.

    Declarative form: one base spec, a ``num_tracks`` axis, the generic
    :meth:`SweepExecutor.run_points` driver."""
    ex = _executor_for(executor, apps)
    base = InterconnectSpec(width=width, height=height, io_ring=True,
                            sb_type=SwitchBoxType.WILTON, reg_density=1.0,
                            cb_track_fc=track_fc, sb_track_fc=track_fc)
    return ex.run_points(spec_grid(base, {"num_tracks": tuple(tracks)}))


def sweep_sb_topology(topologies: Sequence[SwitchBoxType] = (
        SwitchBoxType.WILTON, SwitchBoxType.DISJOINT, SwitchBoxType.IMRAN),
        apps: Optional[Dict[str, Callable]] = None,
        num_tracks: int = 4, width: int = 8, height: int = 8,
        track_fc: float = 0.5,
        executor: Optional[SweepExecutor] = None) -> List[Dict]:
    """§4.2.1 / Fig. 9: topology routability (Wilton routes, Disjoint
    fails). track_fc < 1 reflects depopulated core-port track connections:
    a route is then pinned to its starting track *class*, which Disjoint
    can never leave (its fatal restriction) while Wilton re-permutes
    tracks at every turn."""
    ex = _executor_for(executor, apps)
    base = InterconnectSpec(width=width, height=height,
                            num_tracks=num_tracks, io_ring=True,
                            reg_density=1.0,
                            cb_track_fc=track_fc, sb_track_fc=track_fc)
    recs = ex.run_points(spec_grid(
        base, {"sb_type": tuple(topologies)},
        label=lambda s: {"topology": s.sb_type.value}))
    for rec in recs:
        rec["n_routed"] = sum(1 for r in rec["apps"].values()
                              if r["success"])
        rec["n_apps"] = len(rec["apps"])
    return recs


def sweep_port_connections(kind: str,
                           sides: Sequence[int] = (4, 3, 2),
                           apps: Optional[Dict[str, Callable]] = None,
                           num_tracks: int = 5, width: int = 8,
                           height: int = 8,
                           executor: Optional[SweepExecutor] = None
                           ) -> List[Dict]:
    """§4.2.2 / Figs. 12–15: depopulate SB (core-output) or CB (core-input)
    side connections and measure area + runtime."""
    if kind not in ("sb", "cb"):
        raise ValueError("kind must be 'sb' or 'cb'")
    ex = _executor_for(executor, apps)
    base = InterconnectSpec(width=width, height=height,
                            num_tracks=num_tracks, io_ring=True,
                            sb_type=SwitchBoxType.WILTON, reg_density=1.0)
    axis = f"{kind}_sides"
    return ex.run_points(spec_grid(
        base, {axis: tuple(sides)},
        label=lambda s: {"kind": kind, "sides": getattr(s, axis)}))


def generation_speed(sizes: Sequence[int] = (4, 8, 16, 32),
                     device: DeviceLike = None) -> List[Dict]:
    """Abstract claim: "fast design space exploration" — IR generation +
    lowering speed vs array size (the fabric lowered for ``device``)."""
    from .lowering import compile_interconnect
    from .passes import PassManager
    recs = []
    for s in sizes:
        t0 = time.perf_counter()
        ic = PassManager().run(InterconnectSpec(width=s, height=s,
                                                num_tracks=5,
                                                reg_density=1.0))
        t1 = time.perf_counter()
        fab = compile_interconnect(ic, device=device)
        t2 = time.perf_counter()
        recs.append({"size": s, "nodes": fab.arrays.num_nodes,
                     "gen_seconds": t1 - t0, "lower_seconds": t2 - t1})
    return recs


def _host(x):
    """A result tensor as numpy (synchronizes with the device)."""
    return x.cpu().numpy()


def batched_vs_serial_emulation(width: int = 6, height: int = 6,
                                num_tracks: int = 4, batch: int = 8,
                                cycles: int = 16, use_kernels: bool = True,
                                seed: int = 0,
                                device: DeviceLike = None) -> Dict:
    """Micro-DSE: emulate B random fabric configurations serially
    (``run`` per config: one ``fabric_sweep`` launch per sweep with
    ``use_kernels``) vs as one batch (``run_batch``: one
    ``fabric_fused_batch`` launch per cycle). Returns wall clocks and
    asserts bit-identical observations — the engine behind
    ``benchmarks/dse_speed.py``'s batched-vs-serial comparison."""
    import numpy as np

    fab, cfgs, ext, depths = _random_fabric_workload(
        width, height, num_tracks, batch, cycles, use_kernels, seed, device)
    depth = int(depths.max())

    # warm both paths once so neither timed region is dominated by one-off
    # set-up (kernel library load, table upload)
    fab.run(cfgs[0], ext[0, :2], depth=depth)
    fab.run_batch(cfgs, ext[:, :2], depth=depth)

    t0 = time.perf_counter()
    serial = np.stack([_host(fab.run(cfgs[b], ext[b], depth=depth))
                       for b in range(batch)])
    serial_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    batched = _host(fab.run_batch(cfgs, ext, depth=depth))
    batched_s = time.perf_counter() - t0

    if not np.array_equal(serial, batched):
        raise AssertionError("batched emulation diverged from serial")
    return {"batch": batch, "cycles": cycles, "nodes": fab.arrays.num_nodes,
            "depth": depth, "use_kernels": use_kernels,
            "serial_seconds": serial_s, "batched_seconds": batched_s,
            "speedup": serial_s / max(batched_s, 1e-9)}


def _random_fabric_workload(width: int, height: int, num_tracks: int,
                            batch: int, cycles: int, use_kernels: bool,
                            seed: int, device: DeviceLike = None):
    """Shared fixture for the engine benchmarks: a compiled fabric plus
    random configs / IO streams / per-config depths (numpy)."""
    import numpy as np
    from .lowering import compile_interconnect
    from .passes import PassManager

    ic = PassManager().run(InterconnectSpec(
        width=width, height=height, num_tracks=num_tracks, io_ring=True,
        sb_type=SwitchBoxType.WILTON, reg_density=1.0))
    fab = compile_interconnect(ic, device=device, use_kernels=use_kernels)
    rng = np.random.default_rng(seed)
    cfgs = rng.integers(0, 4, (batch, fab.num_config)).astype(np.int32)
    ext = rng.integers(0, 256, (batch, cycles, fab.num_io)).astype(np.int32)
    depths = np.array([fab.combinational_depth(c) for c in cfgs], np.int32)
    return fab, cfgs, ext, depths


def _timed_min(fn, repeats: int) -> Tuple[Any, float]:
    """Best-of-N wall clock: the min is far less sensitive to scheduler
    noise on shared runners than a single shot."""
    best = float("inf")
    out = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def fused_vs_unfused_emulation(width: int = 6, height: int = 6,
                               num_tracks: int = 4, batch: int = 8,
                               cycles: int = 16, use_kernels: bool = True,
                               seed: int = 0, repeats: int = 3,
                               device: DeviceLike = None) -> Dict:
    """The fused batched engine (whole fixpoint + PE eval in one kernel
    call per cycle) vs the sweep-at-a-time baseline (one
    ``fabric_sweep_batch`` launch per sweep, PyTorch-level PE evaluation
    between launches). Same workload, per-config depths, bit-identical
    outputs asserted — the measured margin is pure fusion."""
    import numpy as np

    fab, cfgs, ext, depths = _random_fabric_workload(
        width, height, num_tracks, batch, cycles, use_kernels, seed, device)

    # warm both engines on the full shapes so the timed regions compare
    # execution, not set-up
    fab.run_batch(cfgs, ext, depth=depths, fused=False, shard=False)
    fab.run_batch(cfgs, ext, depth=depths, fused=True, shard=False)

    unfused, unfused_s = _timed_min(
        lambda: _host(fab.run_batch(cfgs, ext, depth=depths, fused=False,
                                    shard=False)), repeats)
    fused, fused_s = _timed_min(
        lambda: _host(fab.run_batch(cfgs, ext, depth=depths, fused=True,
                                    shard=False)), repeats)
    if not np.array_equal(unfused, fused):
        raise AssertionError("fused engine diverged from unfused baseline")
    return {"batch": batch, "cycles": cycles,
            "nodes": fab.arrays.num_nodes, "use_kernels": use_kernels,
            "max_depth": int(depths.max()), "min_depth": int(depths.min()),
            "unfused_seconds": unfused_s, "fused_seconds": fused_s,
            "speedup": unfused_s / max(fused_s, 1e-9)}


def sharded_vs_single_emulation(width: int = 5, height: int = 5,
                                num_tracks: int = 3, batch: int = 8,
                                cycles: int = 8, use_kernels: bool = True,
                                seed: int = 0, repeats: int = 3,
                                device: DeviceLike = None,
                                _devices: Optional[Sequence] = None) -> Dict:
    """``run_batch`` with the batch split across every visible device
    (``shard=True``) vs the same workload on one device. Bit-identical
    outputs asserted. With a single visible device the split call takes
    the local path, so the record degenerates to a no-regression check;
    ``_devices`` hands the split an explicit device list (as
    :func:`sharded_emulation_probe` does) to see the split itself."""
    import numpy as np

    fab, cfgs, ext, depths = _random_fabric_workload(
        width, height, num_tracks, batch, cycles, use_kernels, seed, device)

    def sharded_run():
        return _host(fab.run_batch(cfgs, ext, depth=depths, shard=True,
                                   _devices=_devices))

    fab.run_batch(cfgs, ext, depth=depths, shard=False)
    sharded_run()

    single, single_s = _timed_min(
        lambda: _host(fab.run_batch(cfgs, ext, depth=depths,
                                    shard=False)), repeats)
    sharded, sharded_s = _timed_min(sharded_run, repeats)
    if not np.array_equal(single, sharded):
        raise AssertionError("sharded emulation diverged from single-device")
    return {"batch": batch, "cycles": cycles,
            "nodes": fab.arrays.num_nodes, "use_kernels": use_kernels,
            "devices": len(fab._split_devices(_devices)),
            "single_seconds": single_s, "sharded_seconds": sharded_s,
            "speedup": single_s / max(sharded_s, 1e-9)}


def sharded_emulation_probe(devices: int = 4, width: int = 4,
                            height: int = 4, num_tracks: int = 2,
                            batch: int = 8, cycles: int = 6,
                            use_kernels: bool = False,
                            device: DeviceLike = None) -> Dict:
    """Run :func:`sharded_vs_single_emulation` with the batch split over
    ``device`` named ``devices`` times (``None``: the CUDA card), in this
    process. The reference forces ``devices`` XLA host devices in a
    subprocess; PyTorch needs no flag for that, since ``run_batch``
    takes an explicit device list. Returns the record, or ``{"error":
    ...}`` when the probe cannot run or the split diverges (where the
    reference's child would exit non-zero)."""
    dev = resolve_device(device)
    try:
        return sharded_vs_single_emulation(
            width=width, height=height, num_tracks=num_tracks, batch=batch,
            cycles=cycles, use_kernels=use_kernels, device=dev,
            _devices=[dev] * devices)
    except Exception as e:                      # the reference's child fails
        return {"error": f"{type(e).__name__}: {e}"}

"""DSE serving front end: spec in, record out, store-backed
(counterpart of repro/serve/dse_service.py).

The ROADMAP's north star is serving DSE results at traffic, not just
computing them in batch jobs. :class:`DSEService` is that serving path:
a thread-safe query front end over the spec-addressed persistent
:class:`repro_torch.core.store.ResultStore`, with one shared
:class:`repro_torch.core.dse.SweepExecutor` behind it.

Request lifecycle for ``query(spec | [specs])``:

1. every spec is resolved against the executor defaults and addressed
   by its digest;
2. digests already in flight (another query computing them right now)
   are *coalesced* — the request piggybacks on the existing computation
   instead of duplicating it;
3. remaining digests are probed in the store (warm hits return without
   touching PnR at all);
4. only the residue of true misses is batched through the executor in
   one ``run_points`` call (shared caches, concurrent points, batched
   device emulation), and written back to the store for the next query.

``submit`` returns a future (the service runs queries on an internal
pool), ``query_async`` bridges that future into asyncio, and
``stats()`` reports hit/miss/coalescing counts and query latency.
``recommend(...)`` runs the search-driven optimizer
(:mod:`repro_torch.core.search`) on the service's executor — the cache
becomes a recommendation engine.

Construct via ``canal_torch.serve(...)``.

"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch.core.dse import SweepExecutor
from repro_torch.core.spec import InterconnectSpec
from repro_torch.core.store import ResultStore

Request = Union[InterconnectSpec, Dict, Sequence]


class DSEService:
    """Coalescing query service over the persistent DSE result store."""

    def __init__(self, store: Optional[ResultStore] = None,
                 executor: Optional[SweepExecutor] = None,
                 max_query_workers: int = 4,
                 **executor_kwargs):
        if executor is not None and executor_kwargs:
            raise TypeError("pass executor kwargs or a prebuilt executor, "
                            "not both")
        if executor is None:
            executor = SweepExecutor(
                store=store if store is not None else ResultStore(),
                **executor_kwargs)
        elif store is not None and executor.store is not store:
            raise ValueError("executor already carries a different store")
        # a caller-provided executor is taken as configured — including
        # store=False/None (deliberately cold runs); the service then
        # still coalesces, it just never serves from disk
        self.executor = executor
        self.store = executor.store
        self._pool = ThreadPoolExecutor(max_workers=max_query_workers,
                                        thread_name_prefix="dse-serve")
        self._lock = threading.Lock()
        self._inflight: Dict[str, Future] = {}
        self.queries = 0
        self.specs_served = 0
        self.hits = 0            # served straight from the store
        self.misses = 0          # required a PnR computation
        self.coalesced = 0       # piggybacked on an in-flight digest
        self._latency_total = 0.0
        self._latency_max = 0.0

    # ---------------------------------------------------------------- query
    def query(self, request: Request) -> Union[Dict, List[Dict]]:
        """Resolve one spec (or a batch of specs / legacy kwargs dicts)
        to DSE records. Single request in -> single record out; sequence
        in -> list out, order preserved."""
        single = isinstance(request, (InterconnectSpec, dict))
        reqs = [request] if single else list(request)
        t0 = time.perf_counter()
        recs = self._query_batch(reqs)
        dt = time.perf_counter() - t0
        with self._lock:
            self.queries += 1
            self.specs_served += len(reqs)
            self._latency_total += dt
            self._latency_max = max(self._latency_max, dt)
        return recs[0] if single else recs

    def _query_batch(self, reqs: List[Request]) -> List[Dict]:
        resolved = [self.executor.resolve(r) for r in reqs]
        digests = [s.digest() for s in resolved]
        results: Dict[str, Dict] = {}
        waits: Dict[str, Future] = {}
        # claims carry (spec, digest, the Future *this query* installed):
        # the digest is never recomputed on the hot path, and every
        # release is identity-checked against that future — a claim slot
        # a later query re-filled for the same digest is never popped or
        # poisoned by this one
        claims: List[tuple] = []
        # classification is O(1) per digest under the lock; store probes
        # (disk reads) happen outside it so concurrent queries don't
        # serialize on each other's I/O
        with self._lock:
            claimed = set()
            for spec, digest in zip(resolved, digests):
                if digest in waits or digest in claimed:
                    continue
                fut = self._inflight.get(digest)
                if fut is not None:
                    waits[digest] = fut
                    self.coalesced += 1
                else:
                    fut = self._inflight[digest] = Future()
                    claimed.add(digest)
                    claims.append((spec, digest, fut))

        def release(digest: str, fut: Future) -> None:
            with self._lock:
                if self._inflight.get(digest) is fut:
                    del self._inflight[digest]

        misses: List[tuple] = []
        failure: Optional[BaseException] = None
        try:
            # the probe loop runs inside the same try/finally as the
            # executor pass: a failure anywhere after claiming (a store
            # probe raising, an interrupt) must still resolve every
            # claimed in-flight future, or later queries for those
            # digests would park on them forever
            for spec, digest, fut in claims:
                rec = self._probe_store(digest)
                if rec is not None:
                    results[digest] = rec
                    with self._lock:
                        self.hits += 1
                    release(digest, fut)
                    fut.set_result(rec)
                else:
                    misses.append((spec, digest, fut))
                    with self._lock:
                        self.misses += 1
            if misses:
                # one batched executor pass over the misses only: shared
                # IR/resource caches, concurrent points, device emulation.
                # record=False: the serving path must not grow the batch
                # workflow's save_json accumulator without bound.
                # assume_cold: the probe loop above already consulted the
                # store for each of these digests — the executor trusts
                # that verdict instead of probing a second time, so a
                # cold point costs exactly one store read
                recs = self.executor.run_points(
                    [(s, {}) for s, _, _ in misses], record=False,
                    assume_cold=True)
                for (spec, digest, fut), rec in zip(misses, recs):
                    results[digest] = rec
                    release(digest, fut)
                    fut.set_result(rec)
        except BaseException as e:
            failure = e
            raise
        finally:
            # failure path: unblock coalesced waiters on every digest
            # this query claimed and did not resolve — with the real
            # exception instead of hanging them (or hiding the cause)
            for spec, digest, fut in claims:
                if not fut.done():
                    release(digest, fut)
                    fut.set_exception(failure or RuntimeError(
                        f"computation for {digest} abandoned"))
        for digest, fut in waits.items():
            results[digest] = fut.result()
        return [dict(results[d]) for d in digests]

    def _probe_store(self, digest: str) -> Optional[Dict]:
        """Warm-path probe, delegating to :meth:`SweepExecutor.probe` —
        one definition of "covers this workload" (app set + emulation
        context, :meth:`SweepExecutor.record_usable`), one store read,
        one hit/miss increment on the executor counters. Misses are
        handed to ``run_points(..., assume_cold=True)``, which trusts
        this verdict instead of probing again — each cold point hits
        the store exactly once."""
        return self.executor.probe(digest)

    # ---------------------------------------------------------------- async
    def submit(self, request: Request) -> Future:
        """Asynchronous :meth:`query`: returns a
        :class:`concurrent.futures.Future` resolving to the record(s)."""
        return self._pool.submit(self.query, request)

    async def query_async(self, request: Request):
        """:meth:`query` bridged into asyncio (awaitable)."""
        import asyncio
        return await asyncio.wrap_future(self.submit(request))

    # ------------------------------------------------------------ recommend
    def recommend(self, base=None, axes: Optional[Dict] = None, *,
                  objective: str = "area",
                  constraints: Optional[Dict] = None,
                  space: Any = None, selector: str = "greedy",
                  budget: int = 32, batch_size: int = 4, seed: int = 0,
                  selector_options: Optional[Dict] = None
                  ) -> Dict[str, Any]:
        """The serving verb for search-driven DSE: "cheapest spec that
        routes these apps under delay D". Runs :func:`repro_torch.core.search.
        search` over ``axes`` around ``base`` (or a prebuilt ``space``)
        on this service's executor — so candidates are store-memoized,
        statically-invalid ones are pruned free, and repeated
        recommendations are all store hits. Returns ``{"best": ...,
        "frontier": [...], "stats": {...}}``; ``best`` is None when no
        evaluated point satisfies ``constraints`` (e.g.
        ``{"max_critical_path_ns": D, "min_routability": 1.0}``)."""
        from repro_torch.core.search import search
        result = search(base, axes, space=space, selector=selector,
                        objective=objective, constraints=constraints,
                        budget=budget, batch_size=batch_size, seed=seed,
                        executor=self.executor,
                        selector_options=selector_options)
        best = result.best(objective, constraints)
        return {"best": best.to_dict() if best is not None else None,
                "frontier": [p.to_dict() for p in result.frontier],
                "stats": result.stats}

    # ----------------------------------------------------------------- misc
    def warm(self, requests: Sequence[Request]) -> Dict[str, int]:
        """Cache-warming pass: compute-and-store every request, report
        how much was already warm. The hit delta is snapshotted around
        this call's query, so with *concurrent* queries in flight their
        hits can land inside the window and inflate ``already_warm`` —
        warm during quiet periods for exact numbers."""
        with self._lock:
            before = self.hits
        self.query(list(requests))
        with self._lock:
            delta = self.hits - before
        return {"requested": len(requests), "already_warm": delta}

    def stats(self) -> Dict[str, Any]:
        # the store scan (an os.listdir walk for the record count) runs
        # outside the query lock: stats polling on a large store must
        # not serialize the query path behind disk I/O
        store_stats = (self.store.stats() if self.store is not None
                       else None)
        with self._lock:
            q = max(self.queries, 1)
            return {
                "queries": self.queries,
                "specs_served": self.specs_served,
                "hits": self.hits, "misses": self.misses,
                "coalesced": self.coalesced,
                "hit_rate": self.hits / max(self.hits + self.misses, 1),
                "latency_avg_s": self._latency_total / q,
                "latency_max_s": self._latency_max,
                "executor": self.executor.stats(),
                "store": store_stats,
            }

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "DSEService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve(store: Optional[Union[ResultStore, str]] = None,
          **kwargs) -> DSEService:
    """Build a :class:`DSEService` (exported as ``canal_torch.serve``).

    ``store`` is a :class:`ResultStore`, a root path, or None (honor
    ``CANAL_TORCH_RESULT_STORE``, else ``.canal_torch_store``); remaining
    kwargs go to the underlying :class:`SweepExecutor` (``apps=``,
    ``emulate_cycles=``, ``device=``, ``use_kernels=``, ...)."""
    if isinstance(store, str):
        store = ResultStore(store)
    return DSEService(store=store, **kwargs)

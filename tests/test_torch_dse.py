"""The port's DSE path against the reference's: ``ResultStore`` and
``record_metrics``, ``SweepExecutor`` records (on the reference's own
routings, carried in through ``repro_torch.interop``), the engine
comparisons, the search selectors and driver, and the ``DSEService``
front end — all on the CPU (``device="cpu"``; the kernel wrappers take
their plain versions)."""
import functools
import json
import os
import random
import threading
import time

import numpy as np
import pytest

import canal
import canal_torch
from repro.core import dse as ref_dse
from repro.core import store as ref_store
from repro.core.pnr.app import BENCH_APPS as REF_APPS
from repro.core.search import search as ref_search
from repro.core.search.selectors import make_selector as ref_make_selector
from repro.core.search.space import SearchSpace as RefSpace
from repro.core.spec import InterconnectSpec as RefSpec
from repro_torch import interop
from repro_torch.core import dse, store
from repro_torch.core.pnr.app import BENCH_APPS, app_pointwise
from repro_torch.core.search import search
from repro_torch.core.search.selectors import make_selector
from repro_torch.core.search.space import SearchSpace
from repro_torch.core.spec import InterconnectSpec

SMALL = dict(width=4, height=4, num_tracks=2, io_ring=True, reg_density=1.0)
ROUTED = dict(width=6, height=6, num_tracks=4, io_ring=True,
              reg_density=1.0)
APPS = ("pointwise", "tree_reduce")
#: wall-clock fields: the only ones allowed to differ between records
CLOCKS = ("seconds", "gen_pnr_seconds")


def _strip(rec):
    """A record without its wall-clock fields, JSON-normalized."""
    rec = json.loads(json.dumps(rec, sort_keys=True, default=str))
    for k in CLOCKS:
        rec.pop(k, None)
    for app in rec.get("apps", {}).values():
        for k in CLOCKS:
            app.pop(k, None)
    return rec


# ---------------------------------------------------------------------------
# ResultStore / record_metrics
# ---------------------------------------------------------------------------

def _records(spec_digest):
    a = {"spec_digest": spec_digest, "sb_area": 12.5, "cb_area": 3.0,
         "emulate_cycles": 8,
         "analysis": {"clean": True, "rule_set": "x"},
         "apps": {"pw": {"success": True, "critical_path_ns": 4.5,
                         "static_ii": 1.0, "min_slack_ns": 5.5},
                  "tr": {"success": False,
                         "critical_path_ns": float("inf")}}}
    b = {"spec_digest": spec_digest, "sb_area": 12.5, "cb_area": 3.0,
         "emulate_cycles": 16,
         "apps": {"tr": {"success": True, "critical_path_ns": 6.0},
                  "fir": {"success": True, "critical_path_ns": 2.0,
                          "static_ii": 2.0}}}
    for r in (a, b):
        r["metrics"] = store.record_metrics(r)
    return a, b


def test_record_metrics_and_merge_match_reference():
    digest = InterconnectSpec(**SMALL).digest()
    a, b = _records(digest)
    for r in (a, b):
        assert store.record_metrics(r) == ref_store.record_metrics(r)
    assert store.merge_records(a, b) == ref_store.merge_records(a, b)
    assert store.merge_records(b, a) == ref_store.merge_records(b, a)


def test_store_round_trip_and_merge_match_reference(tmp_path):
    spec, ref_spec = InterconnectSpec(**SMALL), RefSpec(**SMALL)
    assert spec.digest() == ref_spec.digest()
    a, b = _records(spec.digest())
    mine = store.ResultStore(str(tmp_path / "port"))
    ref = ref_store.ResultStore(str(tmp_path / "ref"))
    for rec in (a, b):
        assert mine.put(spec, rec) == ref.put(ref_spec, rec)
    assert mine.get(spec) == ref.get(ref_spec)
    assert set(mine.get(spec)["apps"]) == {"pw", "tr", "fir"}
    rel = os.path.join("records", f"{spec.digest()}.json")
    with open(tmp_path / "port" / rel) as f, open(tmp_path / "ref" / rel) as g:
        assert json.load(f) == json.load(g)
    assert [r["spec_digest"] for r in mine.for_hardware(spec)] == \
        [r["spec_digest"] for r in ref.for_hardware(ref_spec)]
    assert mine.stats()["writes"] == 2 and len(mine) == 1
    mine.put(spec, a, merge=False)
    assert mine.get(spec) == a


def test_store_default_root_is_the_ports_own(monkeypatch):
    assert store.STORE_ENV != ref_store.STORE_ENV
    assert store.DEFAULT_ROOT != ref_store.DEFAULT_ROOT
    monkeypatch.delenv(store.STORE_ENV, raising=False)
    monkeypatch.setenv(ref_store.STORE_ENV, "/elsewhere/jax_store")
    assert store.default_store_root() == store.DEFAULT_ROOT
    monkeypatch.setenv(store.STORE_ENV, "/x/port_store")
    assert store.default_store_root() == "/x/port_store"
    assert canal_torch.ResultStore().root == "/x/port_store"


# ---------------------------------------------------------------------------
# SweepExecutor on the reference's routings
# ---------------------------------------------------------------------------

def _nets(r):
    nodes = r.routing.resources.nodes
    return [(net.name, nodes[net.src].node_key(),
             [nodes[s].node_key() for s in net.sinks],
             [(nodes[p].node_key(), nodes[c].node_key())
              for p, c in net.edges()])
            for net in r.routing.nets]


@functools.lru_cache(maxsize=None)
def _reference_run():
    """The reference executor's record on ROUTED, and the PnR results it
    computed (in call order)."""
    results = []
    real = ref_dse.place_and_route

    def recording(*args, **kw):
        r = real(*args, **kw)
        results.append(r)
        return r

    ex = ref_dse.SweepExecutor(apps={n: REF_APPS[n] for n in APPS},
                               emulate_cycles=6, use_pallas=False,
                               store=False, max_workers=1)
    ref_dse.place_and_route = recording
    try:
        rec = ex.run_point(RefSpec(**ROUTED))
    finally:
        ref_dse.place_and_route = real
    return rec, results


def _port_executor(monkeypatch, **kw):
    """A port executor whose PnR replays the reference's routings."""
    _, results = _reference_run()
    queue = list(results)

    def replay(ic, app, **pnr_kw):
        r = queue.pop(0)
        mine = interop.pnr_result(ic, app, r.placement, _nets(r),
                                  resources=pnr_kw.get("resources"))
        for k in ("route_iterations", "route_strategy", "place_strategy",
                  "seconds", "error", "alpha"):
            setattr(mine, k, getattr(r, k))
        return mine

    monkeypatch.setattr(dse, "place_and_route", replay)
    kw.setdefault("store", False)
    return dse.SweepExecutor(apps={n: BENCH_APPS[n] for n in APPS},
                             emulate_cycles=6, device="cpu", max_workers=1,
                             **kw)


def test_reference_routes_both_apps():
    rec, results = _reference_run()
    assert [r.success for r in results] == [True, True]
    assert all("emulation" in a for a in rec["apps"].values())


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "inline"])
def test_executor_record_equals_reference(monkeypatch, pipeline):
    want, _ = _reference_run()
    ex = _port_executor(monkeypatch, pipeline_emulation=pipeline)
    got = ex.run_points([(InterconnectSpec(**ROUTED), {})])[0]
    assert _strip(got) == _strip(want)
    assert ex.stats()["pnr_computations"] == 1


def test_executor_store_hit_serves_equal_record(monkeypatch, tmp_path):
    root = str(tmp_path / "s")
    ex = _port_executor(monkeypatch, store=root)
    first = ex.run_point(InterconnectSpec(**ROUTED))
    ex2 = dse.SweepExecutor(apps={n: BENCH_APPS[n] for n in APPS},
                            emulate_cycles=6, device="cpu", store=root)
    again = ex2.run_point(InterconnectSpec(**ROUTED))
    assert _strip(again) == _strip(first)
    assert ex2.stats()["store_hits"] == 1
    assert ex2.stats()["pnr_computations"] == 0


@pytest.mark.parametrize("study", ["batched_vs_serial_emulation",
                                   "fused_vs_unfused_emulation",
                                   "sharded_vs_single_emulation"])
def test_engine_studies_pass(study):
    """Each study asserts bit-identical engines itself; the record keeps
    the reference's keys (``use_kernels`` for ``use_pallas``)."""
    kw = dict(width=4, height=4, num_tracks=2, batch=3, cycles=4)
    extra = {} if study == "batched_vs_serial_emulation" else {"repeats": 1}
    rec = getattr(dse, study)(device="cpu", **kw, **extra)
    ref = getattr(ref_dse, study)(use_pallas=False, **kw, **extra)
    assert set(rec) == (set(ref) - {"use_pallas"}) | {"use_kernels"}
    for k in ("batch", "cycles", "nodes"):
        assert rec[k] == ref[k]
    for k in ("depth", "max_depth", "min_depth"):
        if k in ref:
            assert rec[k] == ref[k]


def test_fifo_area_and_generation_speed_match_reference():
    assert dse.fifo_area_study(num_tracks=2) == \
        ref_dse.fifo_area_study(num_tracks=2)
    mine = dse.generation_speed(sizes=(4,), device="cpu")
    ref = ref_dse.generation_speed(sizes=(4,))
    assert [r["nodes"] for r in mine] == [r["nodes"] for r in ref]


def test_emulation_queue_runs_on_the_executor_device():
    ex = dse.SweepExecutor(device="cpu")
    pool, dev = ex._emu_queue()
    assert str(dev) == "cpu"
    ex.join_pending()


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

class FakeExecutor:
    """Deterministic synthetic evaluator (metrics from the spec digest,
    ~1 in 5 points statically invalid), for either package."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.evals = 0

    def stats(self):
        return {"evaluations": self.evals}

    def run_specs(self, specs, record=False, assume_cold=False):
        recs = []
        for s in specs:
            self.evals += 1
            h = int(s.digest()[:8], 16)
            clean = h % 5 != 0
            success = clean and h % 3 != 0
            rec = {"spec_digest": s.digest(),
                   "sb_area": 10.0 + h % 7, "cb_area": float(h % 5),
                   "analysis": {"clean": clean},
                   "apps": {"a": {"success": success,
                                  "critical_path_ns":
                                      1.0 + h % 9 if success
                                      else float("inf")}}}
            if not clean:
                rec["apps"]["a"]["skipped"] = "static-analysis"
            rec["metrics"] = self.metrics(rec)
            recs.append(rec)
        return recs


AXES = {"num_tracks": (2, 3, 4, 5, 6), "sb_type": ("wilton", "disjoint"),
        "reg_density": (0.5, 1.0)}


@pytest.mark.parametrize("kind", ["random", "greedy", "evolutionary"])
@pytest.mark.parametrize("seed", [0, 11])
def test_search_same_seed_same_proposals_as_reference(kind, seed):
    base = dict(width=6, height=6, io_ring=True)
    got = search(InterconnectSpec(**base), AXES, selector=kind, budget=9,
                 batch_size=3, seed=seed,
                 executor=FakeExecutor(store.record_metrics))
    want = ref_search(RefSpec(**base), AXES, selector=kind, budget=9,
                      batch_size=3, seed=seed,
                      executor=FakeExecutor(ref_store.record_metrics))
    assert [e.digest for e in got.evaluated] == \
        [e.digest for e in want.evaluated]
    assert [e.digest for e in got.frontier] == \
        [e.digest for e in want.frontier]
    assert got.stats == want.stats
    # the selectors on their own, one proposal round
    mine = make_selector(kind, SearchSpace(InterconnectSpec(**base), AXES),
                         random.Random(seed))
    ref = ref_make_selector(kind, RefSpace(RefSpec(**base), AXES),
                            random.Random(seed))
    assert [s.digest() for s in mine.propose(4)] == \
        [s.digest() for s in ref.propose(4)]


def test_search_cli_end_to_end(tmp_path):
    from repro_torch.core.search.cli import run
    out = tmp_path / "frontier.json"
    rc = run(["--width", "6", "--axes", '{"num_tracks": [3, 4]}',
              "--budget", "2", "--apps", "pointwise", "--device", "cpu",
              "--store", str(tmp_path / "s"), "-o", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["frontier"] and doc["stats"]["evaluated"] == 2


def test_search_cli_emulates_through_the_kernels(monkeypatch, tmp_path):
    """The CLI has no switch to the plain engine: its executor always
    takes the kernel path, and the tensors' device picks kernel or plain
    version."""
    from repro_torch.core.search.cli import build_parser, run
    made = []

    class Recording(dse.SweepExecutor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(dse, "SweepExecutor", Recording)
    rc = run(["--width", "6", "--axes", '{"num_tracks": [4]}',
              "--budget", "1", "--apps", "pointwise", "--device", "cpu",
              "--emulate-cycles", "2", "--no-store",
              "-o", str(tmp_path / "f.json")])
    assert rc == 0
    assert len(made) == 1 and made[0].use_kernels is True
    assert str(made[0].device) == "cpu"
    rec = json.loads((tmp_path / "f.json").read_text())
    assert rec["frontier"]
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--axes", "{}", "--kernels"])


def test_executor_takes_pnr_knobs_from_the_spec_only():
    """The port's executor has no deprecated PnR knobs: unset spec
    fields resolve to the reference executor's defaults, set ones win."""
    with pytest.raises(TypeError):
        dse.SweepExecutor(sa_steps=10, device="cpu")
    ex = dse.SweepExecutor(device="cpu")
    ref_ex = ref_dse.SweepExecutor()
    for kw in ({}, {"sa_steps": 7, "seed": 3}):
        got = ex.resolve(InterconnectSpec(**SMALL, **kw))
        want = ref_ex.resolve(RefSpec(**SMALL, **kw))
        assert got.digest() == want.digest()
    with pytest.raises(TypeError):
        dse.sweep_num_tracks(tracks=(2,), sa_steps=5)


def test_canal_torch_front_door_matches_canal():
    assert sorted(canal_torch.__all__) == sorted(canal.__all__)
    space = canal_torch.SearchSpace(InterconnectSpec(**SMALL),
                                    {"num_tracks": (2, 3)})
    assert space.size() == 2


# ---------------------------------------------------------------------------
# DSEService
# ---------------------------------------------------------------------------

def _serve(root, **kw):
    kw.setdefault("apps", {"pw": lambda: app_pointwise(1)})
    kw.setdefault("emulate_cycles", 4)
    return canal_torch.serve(store=root, device="cpu", max_workers=1, **kw)


def test_service_warm_query_hits_only(tmp_path):
    root = str(tmp_path / "s")
    specs = [InterconnectSpec(**SMALL),
             InterconnectSpec(**dict(SMALL, num_tracks=3))]
    with _serve(root) as svc1:
        first = svc1.query(specs)
        assert svc1.stats()["misses"] == 2
    with _serve(root) as svc2:
        again = svc2.query(specs)
        st = svc2.stats()
    assert st["hits"] == 2 and st["misses"] == 0
    assert st["executor"]["pnr_computations"] == 0
    assert [_strip(r) for r in again] == [_strip(r) for r in first]
    assert all("emulation" in r["apps"]["pw"] for r in again)


def test_service_concurrent_queries_coalesce(tmp_path):
    """Two queries for one cold digest in flight at once: exactly one
    computation, the other request waits on it."""
    gate = threading.Event()
    entered = threading.Event()

    def slow_app():
        entered.set()
        assert gate.wait(timeout=30)
        return app_pointwise(1)

    svc = _serve(str(tmp_path / "s"), apps={"pw": slow_app})
    spec = InterconnectSpec(**SMALL)
    f1 = svc.submit(spec)
    assert entered.wait(timeout=30)
    f2 = svc.submit(spec)
    deadline = time.time() + 30
    while svc.stats()["coalesced"] == 0 and time.time() < deadline:
        time.sleep(0.01)
    gate.set()
    r1, r2 = f1.result(timeout=60), f2.result(timeout=60)
    assert _strip(r1) == _strip(r2)
    st = svc.stats()
    assert st["executor"]["pnr_computations"] == 1
    assert st["coalesced"] == 1 and st["misses"] == 1
    svc.close()


def test_service_recommend(tmp_path):
    with _serve(str(tmp_path / "s"), emulate_cycles=0) as svc:
        out = svc.recommend(InterconnectSpec(**dict(ROUTED, num_tracks=3)),
                            {"num_tracks": (2, 3)}, budget=2,
                            constraints={"min_routability": 1.0})
    assert out["frontier"] and out["stats"]["evaluated"] == 2
    assert np.isfinite(out["frontier"][0]["metrics"]["area"])

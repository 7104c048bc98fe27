"""The port's span record (``repro_torch.obs``): parents and trace ids
across threads, the window filter, the bounded buffer, the profiler
ranges, and the spans the program opens where its work happens."""
import collections
import json
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import canal_torch
from repro_torch import obs
from repro_torch.core.dse import SweepExecutor
from repro_torch.core.pnr.app import BENCH_APPS, app_pointwise
from repro_torch.core.spec import InterconnectSpec
from repro_torch.fabric import east_route
from repro_torch.kernels import build

SRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
#: every span the program opens
PROGRAM_SPANS = {
    "ir.passes", "ir.lower", "dse.point", "dse.analysis",
    "dse.routed_analysis", "dse.emulate", "dse.join", "pnr.app",
    "pnr.pack", "pnr.global_place", "pnr.resources", "pnr.detailed_place",
    "pnr.route", "pnr.sta", "emu.bind", "emu.stage", "emu.run",
    "emu.fused", "emu.unpack", "rv.tables", "rv.start", "rv.sweeps",
    "rv.clock"}
SMALL = dict(width=6, height=6, num_tracks=3, io_ring=True)


@pytest.fixture
def small_buffer(monkeypatch):
    """A buffer of four spans and a fresh drop count."""
    monkeypatch.setattr(obs, "_buffer", collections.deque(maxlen=4))
    monkeypatch.setattr(obs, "_dropped", 0)


@pytest.fixture
def counted_ranges(monkeypatch):
    """``torch.profiler.record_function`` counting each range opened."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return opened


def test_nesting_sets_parents_and_a_point_trace_crosses_threads():
    with obs.span("outer") as outer:
        with obs.span("inner") as inner:
            assert obs.current() is inner
        assert obs.current() is outer
    assert obs.current() is None
    assert inner.parent == outer.id and outer.parent is None
    assert outer.trace == outer.id == inner.trace
    assert 0 <= inner.seconds <= outer.seconds

    got = {}
    with obs.span("dse.point", trace="digest-1") as point:
        handed = obs.current()

        def work():
            with obs.span("dse.emulate", parent=handed) as emu:
                with obs.span("emu.run") as run:
                    got.update(emu=emu, run=run)

        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    emu, run = got["emu"], got["run"]
    assert emu.parent == point.id and run.parent == emu.id
    assert point.trace == emu.trace == run.trace == "digest-1"
    assert emu.thread != point.thread == threading.get_ident()


def test_spans_keeps_only_the_interval():
    with obs.span("w.before") as before:
        pass
    t0 = time.perf_counter()
    with obs.span("w.inside") as inside:
        pass
    with obs.span("w.straddles") as straddles:
        t1 = time.perf_counter()
    got = obs.spans(since=t0, until=t1)
    assert inside in got
    assert before not in got and straddles not in got
    assert obs.spans("w.inside", t0, t1) == [inside]
    assert obs.spans("w.before", t0) == []
    assert before in obs.spans("w.before", until=t1)


def test_overfilling_the_buffer_counts_drops(small_buffer):
    for k in range(7):
        with obs.span(f"s{k}"):
            pass
    assert obs.dropped() == 3
    assert [s.name for s in obs.spans()] == ["s3", "s4", "s5", "s6"]


def test_concurrent_spans_lose_no_count(small_buffer):
    """Kept plus dropped equals every span closed, under many threads
    switching often."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with obs.span("stress"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(obs.spans("stress")) + obs.dropped() == 16 * 500


def test_count_launch_adds_n_under_its_lock():
    before = build.LAUNCHES["fabric_sweep"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            build.count_launch("fabric_sweep", 3) for _ in range(500)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert build.LAUNCHES["fabric_sweep"] - before == 16 * 500 * 3


def test_no_profiler_no_range(counted_ranges):
    """Without a profiler no span opens a ``record_function`` range, on a
    place and route and a ready-valid chunk; with one, a span does."""
    t0 = time.perf_counter()
    cf = canal_torch.compile(InterconnectSpec(**SMALL), device="cpu")
    r = cf.place_and_route(app_pointwise(), alphas=(2.0,), sa_steps=10,
                           sa_batch=4)
    assert r.success
    rv = canal_torch.compile(InterconnectSpec(
        width=4, height=4, num_tracks=2, io_ring=True, reg_density=1.0,
        ready_valid=True, split_fifo=True), device="cpu").fabric()
    edges = east_route(rv.ic)
    io = {tuple(c): i for i, c in enumerate(rv.io_coords)}
    src = io[(0, 1)]
    streams = np.zeros((12, rv.num_io), np.int32)
    streams[:4, src] = [5, 6, 7, 8]
    lens = np.zeros(rv.num_io, np.int32)
    lens[src] = 4
    rv.run_with_sources(rv.route_to_config(edges), streams, lens,
                        np.ones((12, rv.num_io), np.int32),
                        depth=len(edges) + 2)
    names = {s.name for s in obs.spans(since=t0)}
    assert {"pnr.app", "pnr.route", "rv.start", "rv.sweeps",
            "rv.clock"} <= names
    assert counted_ranges == []

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("under.profiler"):
            pass
    assert counted_ranges == ["under.profiler"]


def test_profiled_point_shows_program_spans(tmp_path):
    """Under a CPU profiler one design point's spans reach the Chrome
    trace as ``user_annotation`` ranges (those of the profiling thread)."""
    from torch.profiler import ProfilerActivity, profile
    ex = SweepExecutor(apps={"pointwise": BENCH_APPS["pointwise"]},
                       emulate_cycles=4, device="cpu", store=False,
                       max_workers=1)
    spec = InterconnectSpec(**SMALL, sa_steps=10, sa_batch=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = ex.run_points([(spec, {})], record=False)[0]
    assert rec["apps"]["pointwise"]["emulation"]["cycles"] == 4
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    names = {e["name"] for e in events
             if e.get("cat") == "user_annotation"}
    assert {"dse.point", "pnr.route", "dse.join"} <= names


def test_pnr_seconds_is_its_span():
    t0 = time.perf_counter()
    cf = canal_torch.compile(InterconnectSpec(**SMALL), device="cpu")
    r = cf.place_and_route(app_pointwise(), alphas=(1.0, 2.0), sa_steps=10,
                           sa_batch=4)
    spans = obs.spans(since=t0)
    app = [s for s in spans if s.name == "pnr.app"]
    assert len(app) == 1 and r.seconds == app[0].seconds
    stages = [s for s in spans if s.parent == app[0].id]
    assert [s.name for s in stages][:2] == ["pnr.pack", "pnr.global_place"]
    for stage in ("pnr.detailed_place", "pnr.route", "pnr.sta"):
        assert [s.attrs["alpha"] for s in stages
                if s.name == stage] == [1.0, 2.0]
    assert sum(s.seconds for s in stages) <= r.seconds


def test_point_spans_share_the_digest_across_threads():
    t0 = time.perf_counter()
    ex = SweepExecutor(apps={"pointwise": BENCH_APPS["pointwise"]},
                       emulate_cycles=4, device="cpu", store=False)
    spec = InterconnectSpec(**SMALL, sa_steps=10, sa_batch=4)
    rec = ex.run_points([(spec, {})], record=False)[0]
    spans = obs.spans(since=t0)
    point = [s for s in spans if s.name == "dse.point"]
    assert len(point) == 1
    digest = rec["spec_digest"]
    assert point[0].trace == digest
    emu = [s for s in spans if s.name == "dse.emulate"]
    assert len(emu) == 1 and emu[0].parent == point[0].id
    assert emu[0].thread != point[0].thread      # the emulation queue's
    under = {s.name for s in spans if s.trace == digest}
    assert {"dse.analysis", "pnr.resources", "pnr.app", "pnr.route",
            "dse.routed_analysis", "dse.emulate", "ir.lower", "emu.bind",
            "emu.stage", "emu.run", "emu.unpack"} <= under
    assert [s.name for s in spans if s.name == "dse.join"] == ["dse.join"]


def test_program_span_names():
    """Every span of the table is opened in the program, and none takes
    the benchmark's prefixes."""
    found = set()
    for path in SRC.rglob("*.py"):
        found |= set(re.findall(r'\bspan\(\s*"([^"]+)"', path.read_text()))
    assert found == PROGRAM_SPANS
    assert not [n for n in found
                if n.startswith(("trace.", "canalbench."))]

"""The readers of the program's span record (``canalbench/metrics_spans``)
on the small traced DSE cell: the parts never exceed the whole, and a
reader reads nothing where the record lost spans of the window."""
import collections

import pytest

from canalbench import harness
from canalbench.test_canalbench_cells import run_small

DSE = "amber_static.dse_regfree"


@pytest.fixture(scope="module")
def dse_run():
    """The traced small DSE cell's ``Run`` and its result line."""
    runs = []

    class Kept(harness.Run):
        def __init__(self):
            super().__init__()
            runs.append(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "Run", Kept)
    try:
        out = run_small(DSE, trace=True)
    finally:
        mp.undo()
    assert out["correct"], out["checks"]
    return runs[0]


def read(run, name):
    return harness.load_metric(name).read(run)


def test_dse_parts_stay_inside_the_whole(dse_run):
    m = {n: read(dse_run, n) for n in (
        "compile_s.dse", "pnr_app_s", "dse_point_s", "ir_lower_s",
        "dse_analysis_s", "dse_resources_s", "pnr_place_s", "pnr_route_s",
        "dse_emulate_s")}
    assert all(v is not None and v > 0 for v in m.values()), m
    assert m["ir_lower_s"] <= m["compile_s.dse"]
    assert m["pnr_place_s"] + m["pnr_route_s"] <= m["pnr_app_s"]
    points = sum(u["points"] for u in dse_run.units)
    apps = sum(len(u["pnr_seconds"]) for u in dse_run.units) / points
    parts = (m["compile_s.dse"] + m["dse_analysis_s"]
             + m["dse_resources_s"] + apps * m["pnr_app_s"]
             + m["dse_emulate_s"])
    assert parts <= m["dse_point_s"] * 1.02


def test_reader_reads_nothing_after_drops_in_the_window(dse_run,
                                                        monkeypatch):
    from repro_torch import obs
    assert read(dse_run, "pnr_route_s") is not None
    # spans lost before the window leave the window's own whole
    kept = collections.deque(obs.spans(), maxlen=obs.CAPACITY)
    monkeypatch.setattr(obs, "_buffer", kept)
    monkeypatch.setattr(obs, "_dropped", 5)
    assert kept[0].t1 < dse_run.units[0]["t0"]
    assert read(dse_run, "pnr_route_s") is not None
    # a buffer that lost spans and still begins inside the window
    since = dse_run.units[0]["t0"]
    inside = [s for s in obs.spans() if s.t0 >= since]
    monkeypatch.setattr(obs, "_buffer", collections.deque(
        inside, maxlen=len(inside)))
    for name in ("pnr_route_s", "ir_lower_s", "dse_emulate_s"):
        assert read(dse_run, name) is None

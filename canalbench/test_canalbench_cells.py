"""Each cell's harness end to end on the CPU, at a small size, with the
port's plain path; the controls and the planted faults come out not
correct."""
import json

import numpy as np
import pytest
import torch

from canalbench import harness

#: the CPU tests' array where a configuration's file has no ``small``:
#: ``cgra_amber.smoke()`` with one MEM column (the stencil needs one),
#: 8 wide (the butterfly does not fit 6x6)
SMALL = {"width": 8, "height": 8, "track_width": 16, "num_tracks": 3,
         "sb_type": "wilton", "reg_density": 1.0, "io_ring": True,
         "mem_columns": [2]}
#: the ready-valid cells' array: the east stream needs no app
SMALL_RV = dict(SMALL, width=6, height=6, mem_columns=[],
                ready_valid=True, split_fifo=True)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small_cell(name):
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, name)
    config = harness.load_config(cell["config"])
    config["spec"] = config.get("small") or (
        SMALL_RV if config["spec"].get("ready_valid") else SMALL)
    traffic = harness.load_traffic(cell["traffic"])
    traffic.update(harness.load_kind(traffic["kind"]).SMALL_TRAFFIC)
    return bench, cell, config, traffic


def run_small(name, trace=False, control=None, seed=2 ** 31 + 11):
    bench, cell, config, traffic = small_cell(name)
    torch.manual_seed(0)
    return harness.run_cell(bench, cell, seed, 0.5, trace, 0.0,
                            device="cpu", use_kernels=False,
                            control=control, config=config,
                            traffic=traffic)


CELLS = [c["name"] for c in harness.load_benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_with_the_result_keys(name):
    out = run_small(name)
    assert list(out) == KEYS + ["checks"]
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    bench = harness.load_benchmark()
    want = {m["name"] for m in harness.cell_metrics(
        bench, harness.find_cell(bench, name), "end_to_end")}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


@pytest.mark.parametrize("name", CELLS)
def test_traced_cell_adds_the_breakdown(name):
    out = run_small(name, trace=True)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert out["correct"], out["checks"]
    dev = out["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    for key in ("device_ops", "idle_gaps"):
        rows = out["breakdown"][key]
        assert 0 < len(rows) <= 10
        assert all(isinstance(n, str) and s >= 0 for n, s in rows)
    bench = harness.load_benchmark()
    layer = {m["name"] for m in harness.cell_metrics(
        bench, harness.find_cell(bench, name), "per_layer")}
    assert set(out["metrics"]) <= layer
    # CUDA events and the sweeps' launch counters move only on the card
    assert layer - set(out["metrics"]) <= {"rv_sweep_launches_per_cycle",
                                           "emu_batch_ms"}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The control (each route's sweeps cut to what a cheaper run would
    do) fails one of the cell's numbers."""
    out = run_small(name, control="depth")
    assert not out["correct"], out["checks"]


def test_window_closes_at_a_unit_boundary():
    bench, cell, config, traffic = small_cell("amber_static.emulate_regfree")
    out = harness.run_cell(bench, cell, 5, 0.0, False, 0.0, device="cpu",
                           use_kernels=False, config=config,
                           traffic=traffic)
    assert out["attempted"] == traffic["lanes"]


def test_same_seed_same_inputs():
    a = run_small("amber_static.emulate_regfree", seed=3)
    b = run_small("amber_static.emulate_regfree", seed=3)
    assert a["checks"] == b["checks"]
    from canalbench.kinds import emulate
    _, _, config, traffic = small_cell("amber_static.emulate_regfree")
    d1 = emulate.Generator(None, config, traffic, 3, device="cpu")
    d2 = emulate.Generator(None, config, traffic, 4, device="cpu")
    s1 = d1._stimulus(np.random.default_rng([3, 0]))
    s2 = d1._stimulus(np.random.default_rng([3, 0]))
    s3 = d2._stimulus(np.random.default_rng([4, 0]))
    assert all(np.array_equal(s1[k][i], s2[k][i]) for k in range(len(s1))
               for i in s1[k])
    assert not all(np.array_equal(s1[k][i], s3[k][i])
                   for k in range(len(s1)) for i in s1[k])

"""A configuration joins the benchmark with new files only: its file with
its own CPU-size spec (``small``), a mix of an existing kind (whose
``SMALL_TRAFFIC`` shrinks it), its apps, and a module for each PE op the
reference does not hold; ``BENCHMARK.json`` only gains entries. Here all
of them live under ``tmp_path``."""
import copy
import json
from pathlib import Path

import numpy as np
import pytest

from canalbench import harness, reference
from canalbench.test_canalbench_cells import SMALL, SMALL_RV, run_small, \
    small_cell

KINDS = Path(harness.__file__).resolve().parent / "kinds"
ROOM = "room_abs.emulate_abs"
#: the room's CPU array: not the default ``SMALL`` (four tracks, Imran
#: switch boxes, no MEM column)
ROOM_SMALL = {"width": 8, "height": 8, "track_width": 16, "num_tracks": 4,
              "sb_type": "imran", "reg_density": 1.0, "io_ring": True,
              "mem_columns": []}
ABS = """import numpy as np
WIDTH = 16


def apply(port):
    return np.abs(port("data0") - port("data1"))
"""


def _chain(op, depth=6, name="chain"):
    """An app of ``depth`` PEs of ``op`` in a row, each with a constant,
    between one input and one output (``pointwise``'s shape)."""
    inst = [["in0", "io_in", "add", 0], ["out0", "io_out", "add", 0]]
    nets, prev = [], ["in0", "io_out"]
    for i in range(depth):
        inst += [[f"c{i}", "const", "const", 1000 * (i + 1)],
                 [f"pe{i}", "pe", op, 0]]
        nets += [[prev, [[f"pe{i}", "data0"]]],
                 [[f"c{i}", "out"], [[f"pe{i}", "data1"]]]]
        prev = [f"pe{i}", "res0"]
    nets.append([prev, [["out0", "io_in"]]])
    return {"name": name, "instances": inst, "nets": nets}


def _write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


@pytest.fixture
def room(tmp_path, monkeypatch):
    """The new files under ``tmp_path``, the lookups pointed there, and
    ``BENCHMARK.json`` with the room's entries appended."""
    _write(tmp_path / "configs/room_abs.json", {
        "name": "room_abs", "source": "a test's configuration",
        "reduced": [], "small": ROOM_SMALL,
        "spec": dict(ROOM_SMALL, width=32, height=32)})
    _write(tmp_path / "traffic/emulate_abs.json", {
        "kind": "emulate", "apps": ["abs_chain"], "lanes": 16,
        "cycles": 1024, "io_chunk": 8, "trace_units": 2,
        "pnr": {"alphas": [2.0], "sa_steps": 60, "sa_batch": 16}})
    _write(tmp_path / "apps/abs_chain.json", _chain("abs", name="abs_chain"))
    _write(tmp_path / "ops/abs.py", ABS)
    bench = copy.deepcopy(harness.load_benchmark())
    bench["configs"].append({"name": "room_abs", "source": "a test",
                             "file": "canalbench/configs/room_abs.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": ROOM, "config": "room_abs",
                               "traffic": "emulate_abs", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "amber_static.emulate_regfree" in m.get("workloads", ()):
            m["workloads"].append(ROOM)
    monkeypatch.setattr(harness, "load_benchmark",
                        lambda path=None: copy.deepcopy(bench))
    monkeypatch.setattr(harness, "CONFIGS_DIR", tmp_path / "configs")
    monkeypatch.setattr(harness, "TRAFFIC_DIR", tmp_path / "traffic")
    monkeypatch.setattr(reference, "APPS_DIR", tmp_path / "apps")
    monkeypatch.setattr(reference, "OPS_DIR", tmp_path / "ops")
    return bench


def test_room_cell_takes_its_own_small_spec_and_its_kinds_shrink(room):
    _, cell, config, traffic = small_cell(ROOM)
    assert cell["config"] == "room_abs"
    assert config["spec"] == ROOM_SMALL != SMALL
    small = harness.load_kind("emulate").SMALL_TRAFFIC
    assert {k: traffic[k] for k in small} == small
    assert "abs" not in reference._OPS


def test_room_cell_runs_correct_and_its_control_does_not(room):
    out = run_small(ROOM)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "emu_rate"}
    out = run_small(ROOM, control="depth")
    assert not out["correct"], out["checks"]
    assert out["checks"]["wrong_outputs"]["value"] > 0


@pytest.mark.parametrize("mix", ["emulate_regfree", "east_stream"])
def test_configs_without_small_run_the_default_arrays(mix, tmp_path,
                                                      monkeypatch):
    """A configuration's file without ``small`` runs ``SMALL`` on the CPU,
    or ``SMALL_RV`` where its spec is ready-valid."""
    rv = mix == "east_stream"
    spec = dict(ROOM_SMALL, width=32, height=32, ready_valid=rv)
    _write(tmp_path / "plain.json", {"name": "plain", "spec": spec})
    bench = {"workloads": [{"name": "plain.cell", "config": "plain",
                            "traffic": mix, "chips": 1}]}
    monkeypatch.setattr(harness, "load_benchmark",
                        lambda path=None: copy.deepcopy(bench))
    monkeypatch.setattr(harness, "CONFIGS_DIR", tmp_path)
    _, _, config, _ = small_cell("plain.cell")
    assert config["spec"] == (SMALL_RV if rv else SMALL)


@pytest.mark.parametrize("kind", sorted(p.stem for p in KINDS.glob("*.py")
                                        if p.stem != "__init__"))
def test_every_kind_brings_its_cpu_shrink(kind):
    """Each kind's ``SMALL_TRAFFIC`` holds the CPU shrink the cells test
    held for it by kind until the shrink moved into the kind."""
    held = {"dse": dict(points=[["wilton", 3], ["imran", 3]],
                        warm_spec={"width": 6, "height": 6}),
            "emulate": dict(lanes=4, cycles=16, trace_units=1),
            "rv_stream": dict(chunk_cycles=24, tokens=6, drain=12,
                              trace_cycles=2, warm_cycles=1)}
    small = harness.load_kind(kind).SMALL_TRAFFIC
    assert isinstance(small, dict) and small
    assert small == held.get(kind, small)


# ------------------------------------------------------------ op lookup
def test_an_op_found_nowhere_raises_and_names_itself(tmp_path, monkeypatch):
    monkeypatch.setattr(reference, "OPS_DIR", tmp_path)
    x = np.arange(8)
    with pytest.raises(ValueError, match="'frobnicate'"):
        reference.evaluate(_chain("frobnicate", depth=1), {"in0": x})


def test_an_op_module_reads_named_ports(tmp_path, monkeypatch):
    _write(tmp_path / "abs.py", ABS)
    monkeypatch.setattr(reference, "OPS_DIR", tmp_path)
    x = np.random.default_rng(0).integers(0, 1 << 16, (3, 20))
    got = reference.evaluate(_chain("abs", depth=2), {"in0": x})["out0"]
    assert np.array_equal(got, np.abs(np.abs(x - 1000) - 2000))


PRED = """import numpy as np
WIDTH = {width}


def apply(port):
    return {expr}
"""


def _pred_app(widths=None):
    """A 16-bit input compared with a constant (a 1-bit result out on a
    1-bit port), a 1-bit input selecting between the input and the
    constant, and a 16-bit sum out on a 1-bit port."""
    app = {"name": "pred", "instances": [
        ["x", "io_in", "add", 0], ["p", "io_in", "add", 0],
        ["k", "const", "const", 30000],
        ["ge", "pe", "ge", 0], ["mux", "pe", "psel", 0],
        ["sum", "pe", "add", 0],
        ["o_ge", "io_out", "add", 0], ["o_mux", "io_out", "add", 0],
        ["o_sum", "io_out", "add", 0]],
        "nets": [
        [["x", "io_out"], [["ge", "data0"], ["mux", "data0"],
                           ["sum", "data0"]]],
        [["k", "out"], [["ge", "data1"], ["mux", "data1"],
                        ["sum", "data1"]]],
        [["p", "io2f_1"], [["mux", "bit0"]]],
        [["ge", "res0"], [["o_ge", "f2io_1"]]],
        [["mux", "res0"], [["o_mux", "io_in"]]],
        [["sum", "res0"], [["o_sum", "f2io_1"]]]]}
    if widths is not None:
        app["widths"] = widths
    return app


def test_widths_mask_one_bit_ports(tmp_path, monkeypatch):
    _write(tmp_path / "ge.py", PRED.format(
        width=1, expr='(port("data0") >= port("data1")) * 3'))
    _write(tmp_path / "psel.py", PRED.format(
        width=16, expr='np.where(port("bit0") == 1, port("data0"), '
                       'port("data1"))'))
    monkeypatch.setattr(reference, "OPS_DIR", tmp_path)
    rng = np.random.default_rng(1)
    x, p = (rng.integers(0, 1 << 16, (2, 64)) for _ in range(2))
    out = reference.evaluate(_pred_app({"io2f_1": 1, "f2io_1": 1}),
                             {"x": x, "p": p})
    # ge's result wraps at its op's WIDTH, 1 bit
    assert np.array_equal(out["o_ge"], (x >= 30000).astype(np.int64))
    # the 1-bit input wraps at its port's width before psel reads it
    assert np.array_equal(out["o_mux"], np.where(p & 1, x, 30000))
    # a 16-bit result out on a 1-bit port keeps its low bit
    assert np.array_equal(out["o_sum"], (x + 30000) & 1)
    # without widths, ports are words: p is not cut, the sum not either
    out = reference.evaluate(_pred_app(), {"x": x, "p": p})
    assert np.array_equal(out["o_mux"], np.where(p == 1, x, 30000))
    assert np.array_equal(out["o_sum"], (x + 30000) & 0xFFFF)

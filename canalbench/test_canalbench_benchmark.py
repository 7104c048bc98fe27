"""``BENCHMARK.json`` keeps to the benchmark's format, and every name in
it resolves to its file; the command exits without a result on a host
without a card."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from canalbench import harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = ["command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"]


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert list(BENCH) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["canalbench"]
    assert all(_text(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_names_units_and_texts():
    names = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[sec]:
            assert NAME.match(e["name"]), e["name"]
            names.append((sec in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _text(w["why"])
        assert NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])


def test_every_name_resolves_to_its_file():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("canalbench/")
        assert json.loads(path.read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        traffic = harness.load_traffic(w["traffic"])
        harness.load_kind(traffic["kind"]).Generator
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert BENCH["end_to_end"][0]["name"] == "setup_s"
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _text(m["layer"])


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=lambda c: c["name"])
def test_each_cell_reports_setup_another_and_a_layer(cell):
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                   "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.cell_metrics(BENCH, cell, "per_layer")
    assert layer and all(m["moves"] in e2e for m in layer)


def test_command_without_a_card_prints_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "canalbench.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""

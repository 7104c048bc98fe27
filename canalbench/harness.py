"""One run of the benchmark: one cell, one seed, one window.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``BENCHMARK.json`` names the cell, its configuration file
(``canalbench/configs/<config>.json``) and its traffic mix
(``canalbench/traffic/<mix>.json``); the mix names its ``kind``, the
general generator in ``canalbench/kinds/<kind>.py`` that reads it, with
its ``SMALL_TRAFFIC`` for the CPU tests; each metric is a reader
``canalbench/metrics/<metric>.py`` with ``read(run) -> float | None``;
the apps a mix names are ``canalbench/apps/<app>.json``, and a PE op
that the reference does not hold is ``canalbench/ops/<op>.py``
(``canalbench/reference.py``). A configuration's file may carry
``small``, the spec its CPU tests run.

A run: set-up (the kind's ``setup``: load the kernel library, compile,
route, warm one unit of the cell's own shapes), then the window (units
of work until ``seconds`` have passed, closing at the first unit
boundary at or after it), then, with ``trace``, a profiled sample of the
kind's trace units, then the comparison with the plain reference
(``canalbench/reference.py``) that decides ``correct``.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
CONFIGS_DIR = HERE / "configs"
TRAFFIC_DIR = HERE / "traffic"
#: top-level modules that must never be loaded where the result is made
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "canal", "benchmarks",
             "chip_smoke")


class Run:
    """What one run records: the spans, the window's units (each kind's
    record of one unit: its work and counts), the profiled sample's
    summary; the metric readers read it."""

    def __init__(self):
        self.spans: List[Dict[str, Any]] = []
        self.units: List[Dict[str, Any]] = []
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        #: the profiled sample (canalbench/tracing.py), when traced
        self.sample: Optional[Dict[str, Any]] = None
        self._profiling = False

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """A span around a call into the program; named in the profiler's
        trace too while the sample is being profiled."""
        rec = {"name": name, **attrs}
        ctx = contextlib.nullcontext()
        if self._profiling:
            import torch
            ctx = torch.profiler.record_function(name)
        with ctx:
            rec["t0"] = time.perf_counter()
            try:
                yield rec
            finally:
                rec["t1"] = time.perf_counter()
                self.spans.append(rec)


# ------------------------------------------------------------- lookups
def load_benchmark(path: Optional[Path] = None) -> Dict:
    with open(path or CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: Dict, workload: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_config(name: str) -> Dict:
    with open(CONFIGS_DIR / f"{name}.json") as f:
        return json.load(f)


def load_traffic(name: str) -> Dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


def load_kind(kind: str):
    return importlib.import_module(f"canalbench.kinds.{kind}")


def load_metric(name: str):
    """A metric's reader, by file name (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "canalbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: Dict, section: str) -> List[Dict]:
    """The metrics of ``section`` a cell reports: those that list it
    under ``workloads``, and those without the key that move (or, end to
    end, are) a metric the cell reports."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if section == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".", 1)[0] for m in list(
        sys.modules if names is None else names)}
    return sorted(t for t in tops if t in FORBIDDEN)


# ---------------------------------------------------------------- a run
def run_cell(bench: Dict, cell: Dict, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             use_kernels: bool = True, control: Optional[str] = None,
             config: Optional[Dict] = None, traffic: Optional[Dict] = None
             ) -> Dict[str, Any]:
    """Set up, measure and check one run of ``cell``; returns the result
    line's object (``checks`` last). ``config`` and ``traffic`` stand in
    for the cell's files (the CPU tests run them at small sizes)."""
    import torch

    config = config or load_config(cell["config"])
    traffic = traffic or load_traffic(cell["traffic"])
    run = Run()
    gen = load_kind(traffic["kind"]).Generator(
        run, config, traffic, seed, device=device,
        use_kernels=use_kernels, control=control)
    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with run.span("setup"):
        gen.setup()
        sync()
    run.setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    i = 0
    while True:
        with run.span("unit", index=i) as s:
            rec = gen.unit(i)
            sync()
        rec.update(t0=s["t0"], t1=time.perf_counter())
        run.units.append(rec)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0

    if trace:
        from canalbench import tracing
        run.sample = tracing.profile_sample(run, gen, cuda)

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    for m in cell_metrics(bench, cell,
                          "per_layer" if trace else "end_to_end"):
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    gen.release()
    if cuda:
        torch.cuda.empty_cache()

    checks = gen.check()
    attempted, failed = gen.outcome()
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": (torch.cuda.get_device_name(0) if cuda else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": dev}
    if trace and run.sample is not None:
        dev["busy_s"] = run.sample["busy_s"]
        dev["window_s"] = run.sample["window_s"]
        out["breakdown"] = {"device_ops": run.sample["device_ops"],
                            "idle_gaps": run.sample["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out

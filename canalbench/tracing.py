"""The traced sample of a ``--trace 1`` run, read from ``torch.profiler``.

After the window closes, the kind's trace units run once more under the
profiler (CPU and CUDA activity), each inside a benchmark span that is
also a ``record_function`` range, the whole inside ``canalbench.trace``.
The Chrome trace is read back for: the sample's length (``window_s``),
the seconds in which some device operation ran (``busy_s``: the union
of kernel, memcpy and memset intervals), the device seconds inside each
unit span (for the roofline shares), the ten device operations that took
most time, and the ten longest idle gaps, each named by the innermost
benchmark span the host was in.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Tuple

#: trace categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: on a run without a card (the CPU tests) host operators stand in
HOST_CATS = ("cpu_op",)
SAMPLE_SPAN = "canalbench.trace"
TOP = 10
NAME_CHARS = 160


def profile_sample(run, gen, cuda: bool) -> Dict[str, Any]:
    """Profile the generator's trace units; returns the sample's summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    units: List[Dict[str, Any]] = []
    with profile(activities=acts) as prof:
        run._profiling = True
        try:
            with torch.profiler.record_function(SAMPLE_SPAN):
                for j, work in enumerate(gen.trace_units()):
                    name = f"trace.{work['kind']}"
                    with run.span(name):
                        rec = work["run"]()
                        if cuda:
                            torch.cuda.synchronize()
                    units.append({"name": name, "work": rec})
        finally:
            run._profiling = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return summarize(events, units, DEVICE_CATS if cuda else HOST_CATS)


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: List[Dict], units: List[Dict[str, Any]],
              device_cats=DEVICE_CATS) -> Dict[str, Any]:
    """The sample's numbers from Chrome trace events (times in us)."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    window = [e for e in spans if e["name"] == SAMPLE_SPAN]
    if not window:
        raise RuntimeError("the profiler trace lost the sample's span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") in device_cats]
    ops = [(max(a, w0), min(b, w1), n) for a, b, n in ops
           if b > w0 and a < w1]
    busy = _merge([(a, b) for a, b, _ in ops])
    busy_us = sum(b - a for a, b in busy)

    by_name: Dict[str, float] = {}
    for a, b, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    inner = sorted((e for e in spans if e["name"] != SAMPLE_SPAN),
                   key=lambda e: float(e["dur"]))

    def host_span(t: float) -> str:
        for e in inner:
            if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"]):
                return e["name"]
        return SAMPLE_SPAN

    gaps = []
    cur = w0
    for a, b in busy + [[w1, w1]]:
        if a > cur:
            gaps.append((a - cur, cur, a))
        cur = max(cur, b)
    gaps.sort(reverse=True)
    idle = [[host_span((a + b) / 2), d * 1e-6] for d, a, b in gaps[:TOP]]

    # each unit span's device seconds (the spans end with a synchronize)
    unit_spans = [e for e in spans if e["name"].startswith("trace.")]
    unit_spans.sort(key=lambda e: float(e["ts"]))
    for u, e in zip(units, unit_spans):
        a0, a1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        u["device_s"] = sum(min(b, a1) - max(a, a0) for a, b, _ in ops
                            if b > a0 and a < a1) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "units": units,
            "device_ops": [[short_name(n), s * 1e-6] for n, s in top_ops],
            "idle_gaps": idle}


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and cut to ``NAME_CHARS``: a
    PyTorch kernel's full name spells out every template argument."""
    name = name[5:] if name.startswith("void ") else name
    return name[:NAME_CHARS]

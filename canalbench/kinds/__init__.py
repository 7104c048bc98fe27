"""The general generators, one a traffic ``kind``; a mix
(``canalbench/traffic/<mix>.json``) gives one its parameters.

Each module defines ``Generator(run, config, traffic, seed, device,
use_kernels, control)`` with ``setup()``, ``unit(i) -> dict`` (one unit
of the window's work, ended on the host), ``trace_units()`` (what the
traced sample profiles), ``release()`` (drop the program's state),
``check() -> {name: (value, limit)}`` (the comparison with
``canalbench/reference.py``) and ``outcome() -> (attempted, failed)``.
"""
from __future__ import annotations

from typing import Dict

from canalbench import reference


def make_spec(config: Dict, **overrides):
    """The configuration's spec as the port's ``InterconnectSpec``."""
    from repro_torch.core.spec import spec_from_kwargs
    fields = dict(config["spec"])
    fields.update(overrides)
    if "mem_columns" in fields:
        fields["mem_columns"] = tuple(fields["mem_columns"])
    return spec_from_kwargs(**fields)


def app_graph(app: Dict):
    """The port's ``AppGraph`` for a netlist of ``canalbench/apps``."""
    from repro_torch.core.pnr.app import AppGraph
    g = AppGraph()
    for name, kind, op, const in app["instances"]:
        g.add(name, kind, op, const)
    for (src, port), sinks in app["nets"]:
        g.connect(src, port, *(tuple(s) for s in sinks))
    return g


def load_apps(names) -> Dict[str, Dict]:
    return {n: reference.load_app(n) for n in names}


def load_library(device: str, use_kernels: bool) -> None:
    """Build (first run in a checkout) or load the kernel library."""
    if device.startswith("cuda") and use_kernels:
        from repro_torch.kernels import build
        build.library()


def fabric_shape(fab) -> Dict[str, int]:
    """The lowered fabric's sizes that the roofline counts work from."""
    return {"connections": sum(len(n.fan_in) for n in fab.nodes),
            "num_config": int(fab.num_config), "num_pe": int(fab.num_pe),
            "num_io": int(fab.num_io),
            "fifo_stages": int(len(fab.arrays.reg_ids))}


def geometry(config: Dict) -> Dict:
    s = config["spec"]
    return {"width": s["width"], "height": s["height"],
            "mem_columns": s.get("mem_columns", ()),
            "io_ring": s.get("io_ring", False)}

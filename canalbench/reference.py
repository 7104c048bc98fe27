"""The plain reference that decides ``correct``: NumPy only.

It imports nothing of the program (``repro_torch``, ``canal_torch``),
nor JAX. It works from what the benchmark itself makes: the app
netlists under ``canalbench/apps/`` (frozen copies of ``BENCH_APPS`` in
``src/repro_torch/core/pnr/app.py``), the stimuli drawn from the seed,
and the array geometry in the configuration's file. The program's
outputs are read only to be judged.

App semantics (the dataflow graph as the netlist states it):

* values are words of the track width (16 bits); every PE result wraps;
* ``pe``: an op of ``_OPS`` is ``data0 op data1`` (``add``, ``sub``,
  ``mul``, ...); any other op is the module ``canalbench/ops/<op>.py``
  (plain NumPy): ``WIDTH``, its result's bits, and ``apply(port)``, where
  ``port(name)`` is the int64 stream on the PE's input port ``name``,
  as the app's nets name it; the result wraps at ``WIDTH``;
* ``const``: its value; ``io_in``: the stimulus; ``io_out``: its source;
* ``widths`` (optional, in the app's file): ``{port name: bits}`` for
  ports narrower than the word; an ``io_in``'s stimulus wraps at its
  output port's width and an ``io_out`` at its input port's;
* ``reg``: a pipeline register, one cycle of delay (0 before the first);
* ``mem``: a line buffer one word long, ``rdata[t] = wdata[t - 1]`` (the
  apps leave the length open; one word is the assumed size).

Area (``tile_area``): the paper's analytical model of one interior PE
tile's switch box and connection boxes, worked out from the spec's
numbers alone (tracks, sides, core ports), with the GF12-calibrated
constants copied from ``src/repro_torch/core/area.py``.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

APPS_DIR = Path(__file__).resolve().parent / "apps"
#: PE ops beyond ``_OPS``, a module each (``<op>.py``)
OPS_DIR = Path(__file__).resolve().parent / "ops"

#: PE ALU ops of the apps, on int64 streams (wrapped to the word after)
_OPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "min": np.minimum,
    "max": np.maximum,
    "pass": lambda a, b: a,
}


def load_app(name: str) -> Dict:
    """An app netlist: ``instances`` as [name, kind, op, const] and
    ``nets`` as [[src, port], [[sink, port], ...]]."""
    with open(APPS_DIR / f"{name}.json") as f:
        return json.load(f)


def app_ios(app: Dict, kind: str) -> List[str]:
    """Names of the app's ``io_in`` or ``io_out`` instances, in order."""
    return [n for n, k, _, _ in app["instances"] if k == kind]


def _delay(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    out[..., 1:] = x[..., :-1]
    return out


def load_op(op: str):
    """The module of a PE op that ``_OPS`` lacks: ``OPS_DIR/<op>.py``."""
    path = OPS_DIR / f"{op}.py"
    if not (op.isidentifier() and path.is_file()):
        raise ValueError(f"no semantics for PE op {op!r}: not in _OPS "
                         f"and no {path}")
    return _load_op_file(str(path))


@functools.lru_cache(maxsize=None)
def _load_op_file(path: str):
    spec = importlib.util.spec_from_file_location(
        "canalbench.ops." + Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def evaluate(app: Dict, inputs: Dict[str, np.ndarray],
             word_bits: int = 16) -> Dict[str, np.ndarray]:
    """Each ``io_out``'s stream for ``inputs`` (io_in name -> (..., T)
    streams; leading axes are lanes)."""
    mask = (1 << word_bits) - 1
    widths = app.get("widths", {})
    kinds = {n: (k, op, c) for n, k, op, c in app["instances"]}
    source: Dict[Tuple[str, str], Tuple[str, str]] = {}
    out_port: Dict[str, str] = {}    # the port an io_in drives from
    in_port: Dict[str, str] = {}     # the port an io_out is driven on
    for (src, sport), sinks in app["nets"]:
        out_port[src] = sport
        for sink, port in sinks:
            source[(sink, port)] = (src, sport)
            in_port[sink] = port
    shape = np.broadcast(*inputs.values()).shape if inputs else ()
    values: Dict[str, np.ndarray] = {}

    def value(name: str) -> np.ndarray:
        if name in values:
            return values[name]
        kind, op, const = kinds[name]

        def port(p: str) -> np.ndarray:
            return value(source[(name, p)][0])

        if kind == "io_in":
            bits = widths.get(out_port.get(name), word_bits)
            v = np.asarray(inputs[name], np.int64) & ((1 << bits) - 1)
        elif kind == "const":
            v = np.full(shape, const, np.int64)
        elif kind == "io_out":
            p = in_port[name]
            v = port(p)
            if p in widths:
                v = v & ((1 << widths[p]) - 1)
        elif kind == "reg":
            v = _delay(port("in"))
        elif kind == "mem":
            v = _delay(port("wdata"))
        elif kind == "pe" and op in _OPS:
            v = _OPS[op](port("data0"), port("data1")) & mask
        elif kind == "pe":
            mod = load_op(op)
            v = np.asarray(mod.apply(port), np.int64) & (
                (1 << mod.WIDTH) - 1)
        else:
            raise ValueError(f"{name}: no semantics for kind {kind!r}")
        values[name] = np.broadcast_to(v, shape) if v.shape != shape else v
        return values[name]

    return {n: value(n) for n in app_ios(app, "io_out")}


def wrong_streams(app: Dict, inputs: Dict[str, np.ndarray],
                  got: Dict[str, np.ndarray]) -> int:
    """How many of the app's output streams differ from the reference in
    any cycle (a missing stream counts as wrong)."""
    want = evaluate(app, inputs)
    bad = 0
    for name, w in want.items():
        g = got.get(name)
        if g is None or np.shape(g) != w.shape or not np.array_equal(
                np.asarray(g, np.int64), w):
            bad += 1
    return bad


# ------------------------------------------------------------------ area
#: um^2, copied from ``AreaConstants`` in src/repro_torch/core/area.py
MUX2_PER_BIT = 0.6
CONFIG_BIT = 1.2
FF_PER_BIT = 1.0
RV_JOIN_PER_INPUT = 0.4
FIFO_CTRL = {"full": 15.35, "split": 16.2}
#: a PE's core ports (``PECore``: data0-3 in, res0-1 out)
PE_INPUTS, PE_OUTPUTS = 4, 2


def mux_area(n_inputs: int, width: int) -> float:
    """An n:1 mux tree of ``width`` bits and its configuration bits."""
    if n_inputs <= 1:
        return 0.0
    sel = max(1, int(np.ceil(np.log2(n_inputs))))
    return (n_inputs - 1) * MUX2_PER_BIT * width + sel * CONFIG_BIT


def rv_mux_overhead(n_inputs: int) -> float:
    """A mux's 1-bit valid copy and its one-hot ready join (Fig. 5)."""
    if n_inputs <= 1:
        return 0.0
    return (n_inputs - 1) * MUX2_PER_BIT + n_inputs * RV_JOIN_PER_INPUT


def tile_area(spec: Dict) -> Dict[str, float]:
    """SB area (muxes, track registers, and with ready-valid the valid
    copies, joins and FIFO controllers, Fig. 8) and CB area of an
    interior PE tile. Each side's outgoing track is a mux of the three
    other sides' incoming tracks plus the core's outputs where that side
    takes them, then a register and a 2:1 register bypass; each core
    input is a mux over every track of its CB sides."""
    t, w = int(spec["num_tracks"]), int(spec.get("track_width", 16))
    if (float(spec.get("reg_density", 1.0)) != 1.0
            or float(spec.get("sb_track_fc", 1.0)) != 1.0
            or float(spec.get("cb_track_fc", 1.0)) != 1.0):
        raise NotImplementedError("the area reference models full "
                                  "register density and track fc 1.0")
    if spec["width"] // 2 in spec.get("mem_columns", ()):
        raise NotImplementedError("the middle tile is a MEM tile")
    rv = (None if not spec.get("ready_valid")
          else "split" if spec.get("split_fifo") else "full")
    sb_sides = int(spec.get("sb_sides", 4))
    cb_sides = int(spec.get("cb_sides", 4))
    sb = fifo = 0.0
    for side in range(4):
        fan_in = 3 + (PE_OUTPUTS if side < sb_sides else 0)
        for _ in range(t):
            sb += mux_area(fan_in, w) + mux_area(2, w) + FF_PER_BIT * w
            if rv:
                sb += rv_mux_overhead(fan_in) + rv_mux_overhead(2)
                fifo += (FIFO_CTRL[rv] + (FF_PER_BIT * w if rv == "full"
                                          else 0.0))
    cb = PE_INPUTS * mux_area(cb_sides * t, w)
    return {"sb_area": sb + fifo, "cb_area": cb}


def area_mismatch(spec: Dict, record: Dict, rel: float = 1e-9) -> bool:
    """Whether a record's ``sb_area`` / ``cb_area`` differ from the
    model's by more than float summation order can (``rel``)."""
    want = tile_area(spec)
    return any(abs(float(record.get(k, np.nan)) - v) > rel * abs(v)
               or not np.isfinite(float(record.get(k, np.nan)))
               for k, v in want.items())


# ------------------------------------------------------------ placements
def placement_faults(app: Dict, placement: Dict[str, Sequence[int]],
                     geometry: Dict) -> int:
    """Placement rules of the array the configuration states: every PE,
    MEM and IO of the app is placed; PEs on interior tiles outside the
    MEM columns, MEMs on a MEM column, IOs on the ring; no two cores on
    one tile, and no two inputs or two outputs on one IO tile. Returns
    the number of instances that break a rule."""
    w, h = geometry["width"], geometry["height"]
    mem_cols = set(geometry.get("mem_columns", ()))
    ring = bool(geometry.get("io_ring", True))
    seen: Dict[Tuple, str] = {}
    faults = 0
    for name, kind, _, _ in app["instances"]:
        if kind not in ("pe", "mem", "io_in", "io_out"):
            continue
        xy = placement.get(name)
        if xy is None:
            faults += 1
            continue
        x, y = int(xy[0]), int(xy[1])
        edge = x in (0, w - 1) or y in (0, h - 1)
        inside = 0 <= x < w and 0 <= y < h
        if kind == "pe":
            ok = inside and not (ring and edge) and x not in mem_cols
        elif kind == "mem":
            ok = inside and not (ring and edge) and x in mem_cols
        else:
            ok = inside and (edge or not ring)
        slot = ("core", x, y) if kind in ("pe", "mem") else (kind, x, y)
        if not ok or slot in seen:
            faults += 1
        seen[slot] = name
    return faults


# --------------------------------------------------------- ready-valid
def token_faults(sent: np.ndarray, delivered: np.ndarray) -> Dict[str, int]:
    """A stream across the ready-valid fabric delivers every sent token
    once and in order, with its value: tokens missing, extra, and wrong
    in the common prefix."""
    sent = np.asarray(sent, np.int64)
    delivered = np.asarray(delivered, np.int64)
    n = min(len(sent), len(delivered))
    return {"tokens_missing": max(0, len(sent) - len(delivered)),
            "tokens_extra": max(0, len(delivered) - len(sent)),
            "tokens_wrong": int((sent[:n] != delivered[:n]).sum())}


def sum_faults(parts: Iterable[Dict[str, int]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + int(v)
    return out

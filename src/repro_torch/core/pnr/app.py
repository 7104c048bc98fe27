"""Application dataflow graphs for place and route (§3.4).

An application is a netlist of instances (PE ops, memories, registers,
constants, IOs) and nets (driver port -> sink ports), mirroring the packed
netlist format the paper's PnR consumes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class AppInstance:
    name: str
    kind: str                    # pe | mem | io_in | io_out | reg | const
    op: str = "add"              # PE ALU op
    const: int = 0
    # PnR results / attributes
    packed_into: Optional[str] = None

    @property
    def is_movable(self) -> bool:
        return self.kind in ("pe", "mem")


@dataclass
class Net:
    name: str
    src: Tuple[str, str]                      # (instance, port)
    sinks: List[Tuple[str, str]]              # [(instance, port), ...]


@dataclass
class AppGraph:
    instances: Dict[str, AppInstance] = field(default_factory=dict)
    nets: List[Net] = field(default_factory=list)

    # ------------------------------------------------------------ builders
    def add(self, name: str, kind: str, op: str = "add",
            const: int = 0) -> AppInstance:
        if name in self.instances:
            raise ValueError(f"duplicate instance {name}")
        inst = AppInstance(name, kind, op, const)
        self.instances[name] = inst
        return inst

    def connect(self, src: str, src_port: str,
                *sinks: Tuple[str, str], name: Optional[str] = None) -> Net:
        net = Net(name or f"net{len(self.nets)}", (src, src_port),
                  list(sinks))
        self.nets.append(net)
        return net

    def fanin_of(self, inst: str) -> List[Net]:
        return [n for n in self.nets if any(s[0] == inst for s in n.sinks)]

    def fanout_of(self, inst: str) -> List[Net]:
        return [n for n in self.nets if n.src[0] == inst]

    def validate(self) -> None:
        for net in self.nets:
            if net.src[0] not in self.instances:
                raise ValueError(f"net {net.name}: unknown src {net.src[0]}")
            for s, _ in net.sinks:
                if s not in self.instances:
                    raise ValueError(f"net {net.name}: unknown sink {s}")

    def stats(self) -> Dict[str, int]:
        kinds: Dict[str, int] = {}
        for inst in self.instances.values():
            kinds[inst.kind] = kinds.get(inst.kind, 0) + 1
        kinds["nets"] = len(self.nets)
        return kinds


# ---------------------------------------------------------------------------
# Benchmark application suite — small image-pipeline-ish kernels used by the
# paper-style DSE experiments (Figs. 11/14/15 use application run time).
# ---------------------------------------------------------------------------

def app_pointwise(n_ops: int = 4) -> AppGraph:
    """in -> (+1) -> (+2) -> ... -> out : a pipeline of adds."""
    g = AppGraph()
    g.add("in0", "io_in")
    g.add("out0", "io_out")
    prev, prev_port = "in0", "io_out"   # io_in drives through port io_out
    for i in range(n_ops):
        c = g.add(f"c{i}", "const", op="const", const=i + 1)
        p = g.add(f"pe{i}", "pe", op="add")
        g.connect(prev, prev_port, (f"pe{i}", "data0"))
        g.connect(f"c{i}", "out", (f"pe{i}", "data1"))
        prev, prev_port = f"pe{i}", "res0"
    g.connect(prev, prev_port, ("out0", "io_in"))
    return g


def app_tree_reduce(leaves: int = 8, op: str = "add") -> AppGraph:
    """Binary reduction tree over `leaves` inputs."""
    g = AppGraph()
    frontier = []
    for i in range(leaves):
        g.add(f"in{i}", "io_in")
        frontier.append((f"in{i}", "io_out"))
    lvl = 0
    while len(frontier) > 1:
        nxt = []
        for j in range(0, len(frontier) - 1, 2):
            name = f"r{lvl}_{j // 2}"
            g.add(name, "pe", op=op)
            g.connect(frontier[j][0], frontier[j][1], (name, "data0"))
            g.connect(frontier[j + 1][0], frontier[j + 1][1],
                      (name, "data1"))
            nxt.append((name, "res0"))
        if len(frontier) % 2:
            nxt.append(frontier[-1])
        frontier = nxt
        lvl += 1
    g.add("out0", "io_out")
    g.connect(frontier[0][0], frontier[0][1], ("out0", "io_in"))
    return g


def app_fir(taps: int = 4) -> AppGraph:
    """FIR filter: delay line of registers, per-tap multiply, adder chain."""
    g = AppGraph()
    g.add("in0", "io_in")
    g.add("out0", "io_out")
    delayed = [("in0", "io_out")]
    for t in range(1, taps):
        g.add(f"d{t}", "reg")
        g.connect(delayed[-1][0], delayed[-1][1], (f"d{t}", "in"))
        delayed.append((f"d{t}", "out"))
    products = []
    for t in range(taps):
        g.add(f"k{t}", "const", op="const", const=t + 1)
        g.add(f"m{t}", "pe", op="mul")
        g.connect(delayed[t][0], delayed[t][1], (f"m{t}", "data0"))
        g.connect(f"k{t}", "out", (f"m{t}", "data1"))
        products.append((f"m{t}", "res0"))
    acc = products[0]
    for t in range(1, taps):
        g.add(f"a{t}", "pe", op="add")
        g.connect(acc[0], acc[1], (f"a{t}", "data0"))
        g.connect(products[t][0], products[t][1], (f"a{t}", "data1"))
        acc = (f"a{t}", "res0")
    g.connect(acc[0], acc[1], ("out0", "io_in"))
    return g


def app_stencil(width: int = 3) -> AppGraph:
    """1D stencil via mem line buffer + weighted sum (image-pipeline-ish)."""
    g = AppGraph()
    g.add("in0", "io_in")
    g.add("lb", "mem")
    g.add("out0", "io_out")
    g.connect("in0", "io_out", ("lb", "wdata"))
    taps = [("in0", "io_out"), ("lb", "rdata")]
    g.add("m0", "pe", op="add")
    g.connect(taps[0][0], taps[0][1], ("m0", "data0"))
    g.connect(taps[1][0], taps[1][1], ("m0", "data1"))
    prev = ("m0", "res0")
    for i in range(width - 2):
        g.add(f"s{i}", "pe", op="add")
        g.connect(prev[0], prev[1], (f"s{i}", "data0"))
        g.connect(taps[i % 2][0], taps[i % 2][1], (f"s{i}", "data1"))
        prev = (f"s{i}", "res0")
    g.connect(prev[0], prev[1], ("out0", "io_in"))
    return g


def app_butterfly(stages: int = 3) -> AppGraph:
    """FFT-like butterfly exchange network — routing-stressful fanout."""
    n = 1 << stages
    g = AppGraph()
    cur = []
    for i in range(n):
        g.add(f"in{i}", "io_in")
        cur.append((f"in{i}", "io_out"))
    for s in range(stages):
        nxt = []
        half = 1 << s
        for i in range(n):
            j = i ^ half
            name = f"b{s}_{i}"
            g.add(name, "pe", op="add" if i < j else "sub")
            g.connect(cur[i][0], cur[i][1], (name, "data0"))
            g.connect(cur[j][0], cur[j][1], (name, "data1"))
            nxt.append((name, "res0"))
        cur = nxt
    for i in range(n):
        g.add(f"out{i}", "io_out")
        g.connect(cur[i][0], cur[i][1], (f"out{i}", "io_in"))
    return g


BENCH_APPS = {
    "pointwise": lambda: app_pointwise(6),
    "tree_reduce": lambda: app_tree_reduce(8),
    "fir": lambda: app_fir(4),
    "stencil": lambda: app_stencil(3),
    "butterfly": lambda: app_butterfly(2),
}

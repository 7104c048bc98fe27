"""The ready-valid cycle's sweeps kernel (``kernels/rv_sweep.py``) on the
CPU: its plain version, which reads the kernel's own tables in the
kernel's slot order, against ``RVFabric._rv_sweeps`` bit for bit (data,
valid and ready, both buffers); ``_rv_run``'s kernel path (taken here
through ``_rv_path``) against the eager one; the tables' cluster. The
size rule is ``tests/test_torch_kernels.py::test_cluster_plan_size_rule``;
the kernel itself runs on the card: ``tests/test_torch_graph_run.py``."""
import functools

import numpy as np
import pytest
import torch

import canal_torch
from repro_torch.core.pnr.app import app_pointwise
from repro_torch.fabric import AppEmulator, RVFabric, east_route
from repro_torch.fabric import ready_valid
from repro_torch.kernels import rv_sweep


@functools.lru_cache(maxsize=None)
def _compiled(width, split, tracks):
    return canal_torch.compile(canal_torch.InterconnectSpec(
        width=width, height=width, num_tracks=tracks, io_ring=True,
        reg_density=1.0, ready_valid=True, split_fifo=split), device="cpu")


@functools.lru_cache(maxsize=None)
def _case(route, width, split):
    """(fabric, configuration, PE program, route length) of a case: the
    stream east across the fabric; the pointwise app placed and routed
    (its PE program has immediates); random selects (cyclic networks)
    with a random PE program and random immediates."""
    rng = np.random.default_rng(width)
    if route == "app":
        port = _compiled(width, split, 4)
        r = port.place_and_route(app_pointwise(), alphas=(2.0,), sa_steps=20,
                                 sa_batch=8)
        assert r.success, r.error
        fab = port.fabric()
        emu = AppEmulator.from_pnr(fab, r.packed, r)
        return fab, emu.config, emu.pe_cfg, len(r.route_edges())
    fab = _compiled(width, split, 2).fabric()
    if route == "east":
        edges = east_route(fab.ic)
        return fab, fab.route_to_config(edges), None, len(edges)
    p = fab.num_pe
    pe_cfg = {"op": rng.integers(0, 14, p),
              "const": rng.integers(0, 1 << 16, p),
              "imm_mask": rng.integers(0, 2, (p, 4)),
              "imm_val": rng.integers(0, 1 << 16, (p, 4))}
    return (fab, rng.integers(0, 4, fab.num_config), pe_cfg, 2 * width)


def _cycle(fab, config, pe_cfg, rng, stir=False):
    """A cycle's buffers as ``_rv_start`` leaves them, from random FIFO
    state, drive and sink readiness, with stale values in buffer 1. The
    sinks read 0, 1 or 2, so that a min over the consumers shows whether
    it also took the unused consumers' 1. ``stir``: a quarter of buffer
    0's nodes then take random values, the pinned ones too, so that the
    sweeps' results depend on buffer 0 and on the pins apart."""
    cyc = fab._rv_cycle(config, pe_cfg)
    n, r = fab.arrays.num_nodes, len(fab.arrays.reg_ids)

    def ints(high, *shape):
        return torch.as_tensor(rng.integers(0, high, shape), dtype=torch.int32,
                               device=fab.device)

    state = {"slots": ints(1 << 16, r, 2), "occ": ints(3, r),
             "mem": fab._zeros(1)}
    for name in "dvr":
        cyc[name][1][:n] = ints(7, n)
    fab._rv_start(cyc, state, ints(1 << 16, fab.num_io),
                  ints(2, fab.num_io), ints(3, fab.num_io))
    if stir:
        at = torch.as_tensor(rng.random(n) < 0.25, device=fab.device)
        for name, high in (("d", 1 << 16), ("v", 3), ("r", 3)):
            b0 = cyc[name][0][:n]
            b0.copy_(torch.where(at, ints(high, n), b0))
    return cyc


def _tables(fab, cyc, cluster):
    """The kernel's tables: the plan's cluster (``None``), whose counted
    room they keep, or ``cluster`` blocks."""
    if cluster is None:
        tables = fab._rv_tables(cyc)
        assert (tables["cluster"], tables["room"]) == rv_sweep.rv_plan(
            fab._dev("src", fab.arrays.src, torch.int32),
            fab._dev("pe_out", fab.pe_out))
        return tables
    a, pe = fab.arrays, cyc["pe"]
    return rv_sweep.rv_tables(
        fab._dev("src", a.src, torch.int32), cyc["picked"],
        fab._dev("keep", ~a.is_driven, torch.bool),
        fab._dev("rv_pin_ids", fab.rv_pin_ids), fab._dev("pe_in_raw",
                                                         fab.pe_in),
        fab._dev("pe_out", fab.pe_out), pe["op"][0, 0], pe["const"][0],
        pe["imm_mask"][0], pe["imm_val"][0], cyc["cons_used"],
        cluster=cluster)


CASES = [("east", 4), ("east", 6), ("east", 8), ("app", 6), ("app", 8),
         ("random", 6)]


def _same_sweeps(fab, cyc, depth, cluster, sweeps=(rv_sweep.rv_sweeps,)):
    """Each of ``sweeps`` (``rv_sweeps``, which takes its plain version
    for CPU tensors, by default) and ``_rv_sweeps`` from copies of the
    same buffers leave data, valid and ready equal in both buffers."""
    runs = [{k: (tuple(b.clone() for b in v) if isinstance(v, tuple) else v)
             for k, v in cyc.items()} for _ in sweeps]
    tables = _tables(fab, cyc, cluster)
    for fn, run in zip(sweeps, runs):
        fn(tables, run["d"], run["v"], run["r"], run["pins_d"],
           run["pins_v"], run["fix_mask"], run["fix_val"], depth)
    fab._rv_sweeps(cyc, depth)
    for fn, run in zip(sweeps, runs):
        for name in "dvr":
            for k in (0, 1):
                assert torch.equal(run[name][k], cyc[name][k]), \
                    (fn.__name__, cluster, depth, name, k)


def _full_rows(fab, cyc):
    """Pack each node's used consumers into as few columns as the most
    used need (so that the nodes with the most have no unused slot), and
    set buffer 0's ready to 2. Returns the nodes with a full row."""
    n = fab.arrays.num_nodes
    used = cyc["cons_used"]
    width = int((used < n).sum(1).max())
    cyc["cons_used"] = torch.sort(used, dim=1).values[:, :width].contiguous()
    cyc["r"][0][:n] = 2
    return (cyc["cons_used"] < n).all(1)


@pytest.mark.parametrize("cluster", [None, 2, 8])
@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("route,width", CASES)
def test_plain_sweeps_equal_the_eager_sweeps(route, width, split, cluster):
    """The plain version and ``_rv_sweeps`` from the same buffers (as
    ``_rv_start`` leaves them, and stirred) for depths from 0 to past the
    route's length, with the tables' slots in one block (the size rule
    here) or over 2 and 8."""
    fab, config, pe_cfg, length = _case(route, width, split)
    rng = np.random.default_rng([width, split, cluster or 0])
    for depth in sorted({0, 1, 2, 3, length // 2, length + 3}):
        for stir in (False, True):
            cyc = _cycle(fab, config, pe_cfg, rng, stir)
            _same_sweeps(fab, cyc, depth, cluster)
    assert cyc["v"][depth % 2].any() and not cyc["r"][depth % 2].all()


@pytest.mark.parametrize("split", [True, False])
def test_plain_sweeps_with_full_consumer_rows(split):
    """Where every slot of a node's consumer row is used, the backward
    min takes no 1 of an unused consumer. The fabrics have no such node
    (no node has all its 8 consumers select it), so each row's used
    consumers are packed into as few columns as the most used need, and
    buffer 0 reads ready 2: a full row's min is 2 after a sweep."""
    fab, config, pe_cfg, length = _case("random", 6, split)
    n = fab.arrays.num_nodes
    rng = np.random.default_rng(int(split))
    for depth in (1, 2, 3, length + 3):
        cyc = _cycle(fab, config, pe_cfg, rng, stir=True)
        full = _full_rows(fab, cyc)
        _same_sweeps(fab, cyc, depth, None)
        if depth == 1:
            assert (cyc["r"][1][:n][full & ~cyc["fix_mask"]] == 2).any()


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("route", ["east", "app"])
def test_kernel_path_of_a_run_equals_the_eager_run(route, split,
                                                   monkeypatch):
    """``run_with_sources`` and ``run_stream`` with ``_rv_path`` set to
    ``"kernel"`` (one ``rv_sweeps`` call a cycle, its plain version on
    the CPU): the eager run's outputs and FIFO state, a kernel cycle
    counted for each cycle and no graph replay."""
    fab, config, pe_cfg, length = _case(route, 6, split)
    eager = RVFabric(fab.ic, fifo_mode=fab.fifo_mode, device="cpu")
    depth = length + 2
    rng = np.random.default_rng(11)
    t_len, n_io = 24, fab.num_io
    streams = rng.integers(1, 1 << 16, (t_len, n_io)).astype(np.int32)
    lens = rng.integers(0, t_len, n_io).astype(np.int32)
    sink = (rng.random((t_len, n_io)) < 0.6).astype(np.int32)
    monkeypatch.setattr(fab, "_rv_path", lambda depth, cycles: "kernel")
    before = fab.kernel_cycles, fab.graph_replays
    got = fab.run_with_sources(config, streams, lens, sink, pe_cfg=pe_cfg,
                               depth=depth)
    want = eager.run_with_sources(config, streams, lens, sink, pe_cfg=pe_cfg,
                                  depth=depth)
    assert (fab.kernel_cycles - before[0], fab.graph_replays) == \
        (t_len, before[1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k in ("slots", "occ"):
        assert torch.equal(fab.last_state[k], eager.last_state[k])
    assert got[2].any() or route == "app"    # its PE never fires (a fault)
    valid = (streams % 3 > 0).astype(np.int32)
    got = fab.run_stream(config, streams, valid, sink, pe_cfg=pe_cfg,
                         depth=depth)
    want = eager.run_stream(config, streams, valid, sink, pe_cfg=pe_cfg,
                            depth=depth)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fab.kernel_cycles - before[0] == 2 * t_len


def test_rv_path_reads_the_device_the_depth_and_the_size_rule(monkeypatch):
    """The kernel on the card with ``use_kernels`` where the plan gives
    the fabric a cluster, the eager sweeps past the plan, elsewhere and
    for an empty run."""
    fab = _compiled(4, True, 2).fabric()
    assert fab._rv_path(8, 4) == "eager"                       # the CPU
    fab._dev("src", fab.arrays.src, torch.int32)    # the tables stay here
    fab._dev("pe_out", fab.pe_out)
    monkeypatch.setattr(fab, "device", torch.device("cuda"))
    monkeypatch.setattr(fab, "use_kernels", True)
    assert [fab._rv_path(d, c) for d, c in ((8, 4), (0, 4), (8, 0))] == \
        ["kernel", "eager", "eager"]
    monkeypatch.setattr(ready_valid, "rv_plan", lambda src, pe_out: (0, 0))
    assert fab._rv_path(8, 4) == "eager"
    monkeypatch.setattr(ready_valid, "rv_plan", lambda src, pe_out: (16, 9))
    assert fab._rv_path(8, 4) == "kernel"
    monkeypatch.setattr(fab, "use_kernels", False)
    assert fab._rv_path(8, 4) == "eager"


def test_rv_tables_refuse_a_cluster_that_does_not_fit():
    """A cluster size off the ladder, or too small for the fabric's N,
    raises; 16 blocks hold a small fabric. N 20,000 fits no block of 1
    (16 B a slot), and 2 blocks hold it."""
    fab, config, pe_cfg, _ = _case("east", 4, True)
    cyc = fab._rv_cycle(config, pe_cfg)
    with pytest.raises(ValueError, match="no cluster"):
        _tables(fab, cyc, 3)
    assert _tables(fab, cyc, 16)["cluster"] == 16
    n = 20_000
    src = torch.arange(n, dtype=torch.int32)[:, None]
    none = torch.full((n,), n, dtype=torch.int32)
    pe_out = torch.zeros((0, 2), dtype=torch.int32)
    args = (src, none, torch.zeros(n, dtype=torch.bool),
            torch.zeros(0, dtype=torch.int32), torch.zeros((0, 4),
                                                          dtype=torch.int32),
            pe_out, torch.zeros(0, dtype=torch.int32),
            torch.zeros(0, dtype=torch.int32), None, None,
            torch.full((n, 1), n, dtype=torch.int32))
    with pytest.raises(ValueError, match="no cluster of 1 blocks"):
        rv_sweep.rv_tables(*args, cluster=1)
    assert rv_sweep.rv_tables(*args)["cluster"] == 2

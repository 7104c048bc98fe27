"""``FabricModule.run`` on the card, where its sweeps replay from a CUDA
graph: the same observations as the sweep-by-sweep loop (the same sweep
function run eagerly) and as the oracle (``use_kernels=False``), on a
routed app of a 6x6 fabric with a memory column and on a routed app of
``cgra_amber.FULL``, and one ``fabric_sweep`` launch counted for each
sweep; and ``RVFabric`` on the card, whose cycle's sweeps are one launch
of the ``rv_sweeps`` kernel at FULL (CUDA-graph replays past the kernel's
size rule), against its eager sweeps, the CPU and the kernel's plain
version. Needs a card (no JAX):

    python -m pytest -q -m cuda tests/test_torch_graph_run.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build

PNR = dict(alphas=(2.0,), sa_steps=40, sa_batch=8)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _routed(spec, device, pnr):
    from repro_torch.core.compile import compile_spec
    from repro_torch.core.pnr.app import app_pointwise
    from repro_torch.fabric import AppEmulator

    fab = compile_spec(spec, device=device, use_kernels=True)
    r = fab.place_and_route(app_pointwise(3), **pnr)
    assert r.success, r.error
    return fab, AppEmulator.from_pnr(fab.fabric(), r.packed, r)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["6x6", "full"])
def test_graph_run_equals_eager_loop_and_oracle(cuda, size):
    from repro_torch.configs.cgra_amber import FULL
    from repro_torch.core.spec import InterconnectSpec

    if size == "full":
        fab, emu = _routed(FULL, cuda, {})
    else:
        fab, emu = _routed(InterconnectSpec(
            width=6, height=6, num_tracks=4, io_ring=True, sb_type="wilton",
            reg_density=1.0, mem_columns=(3,)), cuda, PNR)
    fabric = fab.fabric()
    t_len = 16
    ext = torch.as_tensor(np.random.default_rng(3).integers(
        0, 1 << 16, (t_len, fabric.num_io)).astype(np.int32), device=cuda)
    args = (emu.config, ext, emu.pe_cfg, emu.depth)

    before = build.LAUNCHES["fabric_sweep"]
    got = fabric.run(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fabric_sweep"] - before == t_len * emu.depth

    cyc = fabric._cycle(emu.config, emu.pe_cfg)
    eager = torch.zeros_like(got)
    before = build.LAUNCHES["fabric_sweep"]
    fabric._eager_cycles(cyc, ext, emu.depth, eager)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fabric_sweep"] - before == t_len * emu.depth

    oracle = fab.fabric(use_kernels=False).run(*args)
    assert got.any()
    assert torch.equal(got, eager) and torch.equal(got, oracle)


def _rv_full(cuda, split):
    """``cgra_amber.FULL`` as a ready-valid fabric on the card (with the
    kernels), the same without them, and on the CPU; the east route and
    its depth."""
    from repro_torch.configs.cgra_amber import FULL
    from repro_torch.core.compile import compile_spec
    from repro_torch.fabric import RVFabric, east_route

    rv = compile_spec(FULL.replace(ready_valid=True, split_fifo=split),
                      device=cuda, use_kernels=True)
    fab, eager = rv.fabric(), rv.fabric(use_kernels=False)
    cpu = RVFabric(rv.interconnect, fifo_mode=fab.fifo_mode, device="cpu")
    edges = east_route(fab.ic)
    depth = len(edges) + 2 if split else fab.depth_for_route(edges)
    return fab, eager, cpu, fab.route_to_config(edges), depth


def _rv_same_as_eager_and_cpu(fab, eager, cpu, config, depth, counted):
    """16 cycles of ``run_with_sources`` under random backpressure and of
    ``run_stream`` on ``fab``: the same outputs and FIFO state as on the
    card's eager sweeps and on the CPU; ``counted(cycles)`` checks the
    path's counters around each run."""
    io = {c: i for i, c in enumerate(fab.io_coords)}
    src = io[(0, 1)]
    t_len = 16
    rng = np.random.default_rng(5)
    streams = np.zeros((t_len, fab.num_io), np.int32)
    streams[:, src] = rng.integers(1, 1 << 16, t_len)
    lens = np.zeros(fab.num_io, np.int32)
    lens[src] = t_len
    sink = (rng.random((t_len, fab.num_io)) < 0.6).astype(np.int32)
    with counted(t_len):
        got = fab.run_with_sources(config, streams, lens, sink, depth=depth)
        torch.cuda.synchronize()
    assert fab.last_state["occ"].any()
    for other in (eager, cpu):
        want = other.run_with_sources(config, streams, lens, sink,
                                      depth=depth)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        for k in ("slots", "occ"):
            assert torch.equal(fab.last_state[k].cpu(),
                               other.last_state[k].cpu())
    valid = (streams > 0).astype(np.int32)
    with counted(t_len):
        got = fab.run_stream(config, streams, valid, sink, depth=depth)
        torch.cuda.synchronize()
    assert got[2].any()
    for other in (eager, cpu):
        want = other.run_stream(config, streams, valid, sink, depth=depth)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        for k in ("slots", "occ"):
            assert torch.equal(fab.last_state[k].cpu(),
                               other.last_state[k].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_rv_graph_run_equals_eager_loop(cuda, split):
    """``RVFabric`` on the card: at FULL each cycle's sweeps are one
    launch of the ``rv_sweeps`` kernel (no graph replayed, a kernel cycle
    counted each cycle), with the same outputs and FIFO state as the same
    sweeps run eagerly (``use_kernels=False``) and as the CPU: the east
    route across ``cgra_amber.FULL`` (31 FIFO stages), 16 cycles of
    ``run_with_sources`` under random backpressure and of
    ``run_stream``."""
    import contextlib

    fab, eager, cpu, config, depth = _rv_full(cuda, split)
    assert fab._rv_path(depth, 16) == "kernel"

    @contextlib.contextmanager
    def counted(cycles):
        before = (build.LAUNCHES["rv_sweeps"], fab.kernel_cycles,
                  fab.graph_replays)
        yield
        assert (build.LAUNCHES["rv_sweeps"] - before[0],
                fab.kernel_cycles - before[1],
                fab.graph_replays) == (cycles, cycles, before[2])

    _rv_same_as_eager_and_cpu(fab, eager, cpu, config, depth, counted)


@pytest.mark.cuda
def test_rv_graph_path_past_the_size_rule(cuda, monkeypatch):
    """A fabric past the kernel's size rule keeps the graph path: with
    the rule patched to refuse FULL, the sweeps replay from CUDA graphs
    (two a sweep pair, the first cycle's first pair run eagerly), with the
    same outputs and FIFO state; no kernel launch."""
    import contextlib

    from repro_torch.fabric import ready_valid

    fab, eager, cpu, config, depth = _rv_full(cuda, True)
    monkeypatch.setattr(ready_valid, "rv_cluster", lambda n, p: 0)

    @contextlib.contextmanager
    def counted(cycles):
        before = build.LAUNCHES["rv_sweeps"], fab.graph_replays
        yield
        assert (build.LAUNCHES["rv_sweeps"] - before[0],
                fab.graph_replays - before[1]) == \
            (0, 2 * (cycles * depth - 1))

    _rv_same_as_eager_and_cpu(fab, eager, cpu, config, depth, counted)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_rv_sweeps_kernel_equals_plain_and_eager(cuda, split):
    """``rv_sweeps`` on the card, its plain version on the card and
    ``_rv_sweeps`` from the same buffers: data, valid and ready equal in
    both buffers, on a 6x6 ready-valid fabric under random selects (cyclic
    networks) and a random PE program with immediates, with each cluster
    size (1, 2, 4, 8 blocks, so that reads and pushes cross blocks) and
    depths 1-40; from buffers as ``_rv_start`` leaves them, stirred, and
    with full consumer rows (``tests/test_torch_rv_sweep.py``)."""
    import canal_torch
    from repro_torch.kernels import rv_sweep
    from test_torch_rv_sweep import _cycle, _full_rows, _same_sweeps

    fab = canal_torch.compile(canal_torch.InterconnectSpec(
        width=6, height=6, num_tracks=2, io_ring=True, reg_density=1.0,
        ready_valid=True, split_fifo=split), device=cuda,
        use_kernels=True).fabric()
    rng = np.random.default_rng(int(split))
    p = fab.num_pe
    pe_cfg = {"op": rng.integers(0, 14, p),
              "const": rng.integers(0, 1 << 16, p),
              "imm_mask": rng.integers(0, 2, (p, 4)),
              "imm_val": rng.integers(0, 1 << 16, (p, 4))}
    config = rng.integers(0, 4, fab.num_config)
    sweeps = (rv_sweep.rv_sweeps, rv_sweep.rv_sweeps_plain)
    launches = 0
    for cluster in (1, 2, 4, 8):
        for depth in (1, 2, 3, 17, 40):
            for variant in ("start", "stir", "full"):
                cyc = _cycle(fab, config, pe_cfg, rng, variant != "start")
                if variant == "full":
                    _full_rows(fab, cyc)
                before = build.LAUNCHES["rv_sweeps"]
                _same_sweeps(fab, cyc, depth, cluster, sweeps)
                torch.cuda.synchronize()
                launches += build.LAUNCHES["rv_sweeps"] - before
    assert launches == 4 * 5 * 3

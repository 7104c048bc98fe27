"""``FabricModule.run`` on the card, where its sweeps replay from a CUDA
graph: the same observations as the sweep-by-sweep loop (the same sweep
function run eagerly) and as the oracle (``use_kernels=False``), on a
routed app of a 6x6 fabric with a memory column and on a routed app of
``cgra_amber.FULL``, and one ``fabric_sweep`` launch counted for each
sweep; and ``RVFabric`` on the card, whose cycle's sweeps are one launch
of the ``rv_sweeps`` kernel (8-block clusters at FULL, 16 past N
116,223), against its eager sweeps, the CPU and the kernel's plain
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


def _rv_full(cuda, split, tracks=5):
    """``cgra_amber.FULL`` (with ``tracks`` tracks) as a ready-valid fabric
    on the card (with the kernels), the same without them, and on the CPU;
    the east route and its depth."""
    from repro_torch.configs.cgra_amber import FULL
    from repro_torch.core.compile import compile_spec
    from repro_torch.fabric import RVFabric, east_route

    rv = compile_spec(FULL.replace(ready_valid=True, split_fifo=split,
                                   num_tracks=tracks),
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


def _kernel_cycles_counted(fab):
    """``counted(cycles)`` for ``_rv_same_as_eager_and_cpu``: one
    ``rv_sweeps`` launch and one kernel cycle a cycle, no graph
    replayed."""
    import contextlib

    @contextlib.contextmanager
    def counted(cycles):
        before = build.LAUNCHES["rv_sweeps"], fab.kernel_cycles
        yield
        assert (build.LAUNCHES["rv_sweeps"] - before[0],
                fab.kernel_cycles - before[1], fab.graph_replays) == \
            (cycles, cycles, 0)
    return counted


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_rv_kernel_run_equals_eager_loop(cuda, split):
    """``RVFabric`` on the card: at FULL each cycle's sweeps are one
    launch of the ``rv_sweeps`` kernel in 8-block clusters (a kernel
    cycle counted each cycle), with the same outputs and FIFO state as
    the same sweeps run eagerly (``use_kernels=False``) and as the CPU:
    the east route across ``cgra_amber.FULL`` (31 FIFO stages), 16 cycles
    of ``run_with_sources`` under random backpressure and of
    ``run_stream``."""
    from repro_torch.kernels import rv_sweep

    fab, eager, cpu, config, depth = _rv_full(cuda, split)
    assert fab._rv_path(depth, 16) == "kernel"
    assert fab._rv_tables(fab._rv_cycle(config, None))["cluster"] == 8
    assert rv_sweep.rv_plan(fab._dev("src", fab.arrays.src, torch.int32),
                            fab._dev("pe_out", fab.pe_out))[0] == 8
    _rv_same_as_eager_and_cpu(fab, eager, cpu, config, depth,
                              _kernel_cycles_counted(fab))


@pytest.mark.cuda
def test_rv_run_in_16_block_clusters_past_8_blocks(cuda):
    """Past 8 blocks' reach (N 116,223) the kernel runs in non-portable
    16-block clusters: ``cgra_amber.FULL`` with 7 tracks (N 118,544)
    gives the same outputs and FIFO state as its eager sweeps and as the
    CPU, one launch and one kernel cycle a cycle, no graph replayed."""
    from repro_torch.kernels import rv_sweep

    fab, eager, cpu, config, depth = _rv_full(cuda, True, tracks=7)
    n = fab.arrays.num_nodes
    assert 116_223 < n == 118_544
    assert fab._rv_path(depth, 16) == "kernel"
    assert rv_sweep.rv_plan(fab._dev("src", fab.arrays.src, torch.int32),
                            fab._dev("pe_out", fab.pe_out))[0] == 16
    _rv_same_as_eager_and_cpu(fab, eager, cpu, config, depth,
                              _kernel_cycles_counted(fab))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_rv_sweeps_kernel_equals_plain_and_eager(cuda, split):
    """``rv_sweeps`` on the card, its plain version on the card and
    ``_rv_sweeps`` from the same buffers: data, valid and ready equal in
    both buffers, on a 6x6 ready-valid fabric under random selects (cyclic
    networks) and a random PE program with immediates, with each cluster
    size (1, 2, 4, 8, 16 blocks, so that reads and pushes cross blocks) and
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
    for cluster in (1, 2, 4, 8, 16):
        for depth in (1, 2, 3, 17, 40):
            for variant in ("start", "stir", "full"):
                cyc = _cycle(fab, config, pe_cfg, rng, variant != "start")
                if variant == "full":
                    _full_rows(fab, cyc)
                before = build.LAUNCHES["rv_sweeps"]
                _same_sweeps(fab, cyc, depth, cluster, sweeps)
                torch.cuda.synchronize()
                launches += build.LAUNCHES["rv_sweeps"] - before
    assert launches == 5 * 5 * 3

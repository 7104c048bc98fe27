"""``FabricModule.run`` on the card, where its sweeps replay from a CUDA
graph: the same observations as the sweep-by-sweep loop (the same sweep
function run eagerly) and as the oracle (``use_kernels=False``), on a
routed app of a 6x6 fabric with a memory column and on a routed app of
``cgra_amber.FULL``, and one ``fabric_sweep`` launch counted for each
sweep. Needs a card (no JAX):

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


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_rv_graph_run_equals_eager_loop(cuda, split):
    """``RVFabric`` on the card: its sweeps replay from CUDA graphs (two
    a sweep pair, the first cycle's first pair run eagerly), with the
    same outputs and FIFO state as the same sweeps run eagerly
    (``use_kernels=False``) and as the CPU: the east route across
    ``cgra_amber.FULL`` (31 FIFO stages), 16 cycles of
    ``run_with_sources`` under random backpressure and of
    ``run_stream``."""
    from repro_torch.configs.cgra_amber import FULL
    from repro_torch.core.compile import compile_spec
    from repro_torch.fabric import RVFabric, east_route

    rv = compile_spec(FULL.replace(ready_valid=True, split_fifo=split),
                      device=cuda, use_kernels=True)
    fab, eager = rv.fabric(), rv.fabric(use_kernels=False)
    cpu = RVFabric(rv.interconnect, fifo_mode=fab.fifo_mode, device="cpu")
    edges = east_route(fab.ic)
    config = fab.route_to_config(edges)
    depth = len(edges) + 2 if split else fab.depth_for_route(edges)
    io = {c: i for i, c in enumerate(fab.io_coords)}
    src = io[(0, 1)]
    t_len = 16
    rng = np.random.default_rng(5)
    streams = np.zeros((t_len, fab.num_io), np.int32)
    streams[:, src] = rng.integers(1, 1 << 16, t_len)
    lens = np.zeros(fab.num_io, np.int32)
    lens[src] = t_len
    sink = (rng.random((t_len, fab.num_io)) < 0.6).astype(np.int32)
    before = fab.graph_replays
    got = fab.run_with_sources(config, streams, lens, sink, depth=depth)
    torch.cuda.synchronize()
    assert fab.graph_replays - before == 2 * (t_len * depth - 1)
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
    got = fab.run_stream(config, streams, valid, sink, depth=depth)
    want = eager.run_stream(config, streams, valid, sink, depth=depth)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[2].any()

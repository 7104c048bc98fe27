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

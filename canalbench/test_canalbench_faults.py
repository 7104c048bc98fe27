"""The planted faults: the harness driven on the CPU, at a small size,
with the timed path broken underneath, comes out not correct."""
import pytest
import torch

from canalbench import harness
from canalbench.test_canalbench_cells import CELLS, run_small


# ------------------------------------------------------ planted faults
def _planted(monkeypatch, fault):
    """Break the emulation underneath ``run_apps_batch``: the state left
    unchanged (nothing settles), half of the batch's lanes left out, or
    one answer altered where it is produced."""
    from repro_torch.core.lowering import FabricModule
    orig = FabricModule.run_batch

    def run_batch(self, configs, ext, *a, **kw):
        out = orig(self, configs, ext, *a, **kw)
        out = out.clone()
        if fault == "stale":
            out.zero_()
        elif fault == "half":
            out[out.shape[0] // 2:] = 0
        else:
            out[0, -1] += 1
        return out

    monkeypatch.setattr(FabricModule, "run_batch", run_batch)


STATIC = [n for n in CELLS if harness.find_cell(
    harness.load_benchmark(), n)["traffic"] != "east_stream"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", STATIC)
def test_planted_emulation_fault_is_not_correct(monkeypatch, name, fault):
    _planted(monkeypatch, fault)
    out = run_small(name)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_planted_ready_valid_fault_is_not_correct(monkeypatch, fault):
    """The ready-valid clock broken: FIFO state left unchanged (no token
    moves), every other token dropped at the sink, or a delivered
    token's value altered."""
    from repro_torch.fabric import RVFabric
    orig = RVFabric._rv_clock
    calls = {"n": 0}

    def clock(self, cyc, state, depth):
        new, (od, ov, orr) = orig(self, cyc, state, depth)
        calls["n"] += 1
        if fault == "stale":
            new, ov = state, torch.zeros_like(ov)
        elif fault == "half" and calls["n"] % 2:
            ov = torch.zeros_like(ov)
        elif fault == "altered":
            od = od + 1
        return new, (od, ov, orr)

    monkeypatch.setattr(RVFabric, "_rv_clock", clock)
    out = run_small("amber_rv.east")
    assert not out["correct"], (fault, out["checks"])

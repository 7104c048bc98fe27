"""The port's import boundary: ``repro_torch`` / ``canal_torch`` load
neither JAX nor the reference package, import none of it in source, and
their default-device entry points refuse to run without CUDA."""
import os
import re
import subprocess
import sys

import pytest
import torch

import canal_torch
from repro_torch.configs import get_smoke
from repro_torch.configs.cgra_amber import smoke
from repro_torch.core.lowering import FabricModule
from repro_torch.core.passes import PassManager
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|from\s+repro\.|import\s+repro\b"
    r"|from\s+repro\s+import|import\s+canal\b|from\s+canal\b)", re.M)

_PROBE = """
import sys
import repro_torch, canal_torch
import repro_torch.interop, repro_torch.fabric, repro_torch.core.pnr
import repro_torch.kernels.ops, repro_torch.configs.cgra_amber
import repro_torch.models, repro_torch.serve.engine, repro_torch.launch.serve
import repro_torch.configs.tinyllama_1_1b, repro_torch.configs.mamba2_1_3b
from repro_torch.configs import list_archs, get_config
[get_config(a) for a in list_archs()]
import repro_torch.train.step, repro_torch.optim, repro_torch.ckpt
import repro_torch.data, repro_torch.runtime, repro_torch.launch.train
import repro_torch.roofline, repro_torch.core.ici
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "canal"))
print("LOADED", bad)
"""


def test_import_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "LOADED []", out.stdout


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for pkg in ("repro_torch", "canal_torch"):
        for dirpath, _, files in os.walk(os.path.join(SRC, pkg)):
            paths += [os.path.join(dirpath, f) for f in files
                      if f.endswith(".py")]
    return paths


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax_and_no_reference(path):
    with open(path) as f:
        text = f.read()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def test_default_device_raises_without_cuda(monkeypatch):
    """``device=None`` means the card: with no CUDA the entry points
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        canal_torch.compile(smoke())
    ic = PassManager().run(smoke())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FabricModule(ic)
    # the CPU is used only when asked for
    assert canal_torch.compile(smoke(), device="cpu",
                               analyze="off").device.type == "cpu"
    # the LM substrate: models, the serving and training launchers
    lm = get_smoke("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(lm)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--smoke", "--steps", "1"])
    assert build_model(lm, "cpu").device.type == "cpu"


def test_unported_paths_raise():
    """The ready-valid fabric builds (the port's ``RVFabric``, in the mode
    the IR's ``rv_fifo_mode`` names), while its lowered verification
    raises, as in the reference, which verifies only the static
    interconnect."""
    from repro_torch.fabric import RVFabric

    for split, mode in ((False, "full"), (True, "split")):
        rv = canal_torch.compile(
            canal_torch.InterconnectSpec(width=4, height=4, num_tracks=2,
                                         ready_valid=True, split_fifo=split),
            device="cpu", analyze="off")
        fab = rv.fabric()
        assert isinstance(fab, RVFabric)
        assert fab.fifo_mode == rv.interconnect.params["rv_fifo_mode"] == mode
        with pytest.raises(NotImplementedError):
            rv.verify()


def test_readyvalid_rejects_unsupported_fifo_depth():
    """As in the reference: the lowering implements depth-2 FIFOs only."""
    spec = canal_torch.InterconnectSpec(width=4, height=4, num_tracks=2,
                                        ready_valid=True, fifo_depth=8)
    with pytest.raises(ValueError, match="depth-2"):
        canal_torch.compile(spec, device="cpu")

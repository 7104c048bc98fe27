"""The port's four examples (``examples/torch_*.py``) run on the CPU at
a small size, through the flags each example takes (``--device cpu``
and its size flags); each asserts its own result and prints ``OK``.
``chip_smoke.py`` runs them on the card."""
import importlib.util
import os

import pytest

import canal_torch
from repro_torch.configs import list_archs

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_example(name, argv, capsys):
    load_example(name).main(argv)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK"), out[-2000:]
    return out


def test_quickstart(capsys):
    out = run_example("torch_quickstart", ["--device", "cpu"], capsys)
    assert "bitstream:" in out and "latency" in out


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-2b",
                                  "whisper-medium", "mamba2-1.3b"])
def test_serve_lm(arch, capsys):
    out = run_example("torch_serve_lm", ["--device", "cpu", "--arch", arch],
                      capsys)
    assert out.count("-> generated=") == 5


@pytest.mark.parametrize("arch", list_archs())
def test_train_tinylm_every_arch(arch, capsys):
    """Every arch trains (patches and frames stubbed for the VLM and
    Whisper), through a failure half way and its restore."""
    out = run_example("torch_train_tinylm", ["--device", "cpu", "--arch",
                                             arch, "--steps", "12"], capsys)
    assert "after 1 restart" in out


def test_cgra_dse_and_its_store(tmp_path, capsys):
    """The DSE example on an 8x8 fabric with a small grid and budget; run
    again on the same store, it computes no PnR."""
    argv = ["--device", "cpu", "--store", str(tmp_path / "store"),
            "--size", "8", "--tracks", "2,3", "--budget", "2",
            "--sa-steps", "10"]
    first = run_example("torch_cgra_dse", argv, capsys)
    assert "wilton    routed 1/1" in first
    again = run_example("torch_cgra_dse", argv, capsys)
    assert "misses=0" in again and " 0 new PnR" in again


class Asked(Exception):
    """Raised in place of the fabric's front door, carrying its keywords."""


@pytest.mark.parametrize("device,kernels", [
    (None, True), ("cuda", True), ("cuda:0", True), ("cuda:1", True),
    ("cpu", False)])
@pytest.mark.parametrize("name,door", [("torch_quickstart", "compile"),
                                       ("torch_cgra_dse", "serve")])
def test_fabric_examples_ask_for_the_kernels_on_any_card(
        name, door, device, kernels, monkeypatch):
    """The fabric examples ask for the hand-written kernels on every CUDA
    device they are given (``--device cuda:1`` too), and for the plain
    version on the CPU only; the front door is stubbed, so no card is
    needed."""
    def stub(*args, **kw):
        raise Asked(kw)

    monkeypatch.setattr(canal_torch, door, stub)
    argv = [] if device is None else ["--device", device]
    with pytest.raises(Asked) as asked:
        load_example(name).main(argv)
    kw = asked.value.args[0]
    assert kw["device"] == device and kw["use_kernels"] is kernels

"""The multi-device ``FabricModule.run_batch`` split of the port (the
reference's ``shard_map`` over the batch axis) and
``sharded_emulation_probe``.

On the CPU the split runs over the CPU named several times (a device
list the probe hands ``run_batch``): every chunk on its own thread, on
the fabric lowered on its device, and the rows back in order. It must be
bit-identical to the unsplit run and to the reference's ``run_batch`` on
the same workload: B not a multiple of the device count, B smaller than
the count, and B = 0, on both engines and the streamed one. The split
over several physical cards is unproven (the card machine has one); the
``cuda`` case runs it over the card named twice.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dse as ref_dse
from repro_torch.core import dse
from repro_torch.core.lowering import FabricModule

CPU = torch.device("cpu")


def workload(batch, seed=0, cycles=5, use_kernels=False, device="cpu"):
    return dse._random_fabric_workload(4, 4, 2, batch, cycles, use_kernels,
                                       seed, device)


@pytest.mark.parametrize("n_dev, batch", [(3, 7), (4, 2), (3, 0), (2, 8),
                                          (5, 5)])
@pytest.mark.parametrize("engine", ["fused", "unfused", "kernels",
                                    "streamed"])
def test_split_is_bit_identical(n_dev, batch, engine):
    kernels = engine in ("kernels", "streamed")
    fab, cfgs, ext, depths = workload(batch, seed=n_dev,
                                      use_kernels=kernels)
    kw = dict(depth=depths, fused=engine != "unfused",
              io_chunk=4 if engine == "streamed" else None)
    single = fab.run_batch(cfgs, ext, shard=False, **kw)
    split = fab.run_batch(cfgs, ext, shard=True, _devices=[CPU] * n_dev,
                          **kw)
    assert split.shape == single.shape == (batch, 5, fab.num_io)
    assert split.dtype == single.dtype
    np.testing.assert_array_equal(split.numpy(), single.numpy())


def test_split_equals_the_reference():
    """The port's split run and the reference's (unsplit, one device)
    ``run_batch`` on the same configurations, streams and depths."""
    fab, cfgs, ext, depths = workload(7, seed=3)
    ref_fab, _, _, _ = ref_dse._random_fabric_workload(4, 4, 2, 7, 5, False,
                                                       3)
    want = np.asarray(ref_fab.run_batch(jnp.asarray(cfgs), jnp.asarray(ext),
                                        depth=depths))
    got = fab.run_batch(cfgs, ext, depth=depths, _devices=[CPU] * 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_shard_none_splits_when_several_devices_are_visible(monkeypatch):
    """``shard=None`` splits whenever the resolver sees more than one
    device, as the reference's does; ``shard=False`` stays local; one
    device stays local whatever ``shard`` says."""
    fab, cfgs, ext, depths = workload(5)
    calls = []
    real = FabricModule._run_batch_split

    def spy(self, devices, *args):
        calls.append(len(devices))
        return real(self, devices, *args)

    monkeypatch.setattr(FabricModule, "_run_batch_split", spy)
    want = fab.run_batch(cfgs, ext, depth=depths).numpy()
    assert calls == []                         # the CPU module: one device
    fab.run_batch(cfgs, ext, depth=depths, shard=True)
    assert calls == []
    monkeypatch.setattr(fab, "_split_devices", lambda devices=None: (
        [CPU] * 2 if devices is None else list(devices)))
    for shard, split in ((None, True), (True, True), (False, False)):
        calls.clear()
        got = fab.run_batch(cfgs, ext, depth=depths, shard=shard)
        assert calls == ([2] if split else [])
        np.testing.assert_array_equal(got.numpy(), want)


def test_split_devices_resolver(monkeypatch):
    fab, *_ = workload(1)
    assert fab._split_devices() == [CPU]
    assert fab._split_devices(["cpu", "cpu"]) == [CPU, CPU]
    fake = object.__new__(FabricModule)
    fake.__dict__.update(fab.__dict__)
    fake.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert fake._split_devices() == [torch.device("cuda", i)
                                     for i in range(3)]


def test_split_reraises_a_chunk_failure(monkeypatch):
    fab, cfgs, ext, depths = workload(4)
    monkeypatch.setattr(FabricModule, "_run_batch_local",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("chunk failed")))
    with pytest.raises(RuntimeError, match="chunk failed"):
        fab.run_batch(cfgs, ext, depth=depths, _devices=[CPU] * 2)


def test_probe_returns_the_reference_record():
    """``sharded_emulation_probe`` in this process over the CPU named
    four times: the reference's record keys (``use_kernels`` for
    ``use_pallas``), four devices, and the reference probe's workload."""
    rec = dse.sharded_emulation_probe(devices=4, device="cpu")
    assert "error" not in rec, rec
    ref = ref_dse.sharded_vs_single_emulation(
        width=4, height=4, num_tracks=2, batch=8, cycles=6,
        use_pallas=False, repeats=1)
    assert set(rec) == (set(ref) - {"use_pallas"}) | {"use_kernels"}
    assert rec["devices"] == 4
    for k in ("batch", "cycles", "nodes"):
        assert rec[k] == ref[k]
    assert rec["use_kernels"] is False


def test_probe_reports_a_divergent_split(monkeypatch):
    """Where the reference's child process would exit non-zero (the
    split diverges), the probe returns ``{"error": ...}``."""
    real = FabricModule._run_batch_split

    def off_by_one(self, *args):
        return real(self, *args) + 1

    monkeypatch.setattr(FabricModule, "_run_batch_split", off_by_one)
    rec = dse.sharded_emulation_probe(devices=2, batch=3, cycles=2,
                                      device="cpu")
    assert set(rec) == {"error"}
    assert "diverged" in rec["error"]


def test_executor_queue_follows_the_reference_shard_rule(monkeypatch):
    """Several cards and ``shard=None``: one queue feeding the split;
    ``shard=False``: a queue a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for shard, want in ((None, [None]), (True, [None]),
                        (False, [torch.device("cuda", 0),
                                 torch.device("cuda", 1)])):
        ex = dse.SweepExecutor(device="cpu", shard=shard)
        ex.device = torch.device("cuda")
        ex._emu_queue()
        assert ex._emu_devices == want
        ex._emu_pool.shutdown()


# ------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 5, 1])
def test_card_named_twice_is_bit_identical(batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    fab, cfgs, ext, depths = workload(batch, use_kernels=True,
                                      device=card)
    single = fab.run_batch(cfgs, ext, depth=depths, shard=False)
    split = fab.run_batch(cfgs, ext, depth=depths, _devices=[card] * 2)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(split.cpu().numpy(), single.cpu().numpy())
    rec = dse.sharded_emulation_probe(devices=2, batch=batch,
                                      use_kernels=True, device=card)
    assert "error" not in rec, rec


def test_split_and_launch_counts_under_thread_stress():
    """More chunks than cores with a short switch interval: the split
    stays bit-identical, and the wrappers' launch counts (incremented
    from every chunk's thread) lose no update."""
    import os
    import sys
    import threading

    from repro_torch.kernels import build

    n_dev = (os.cpu_count() or 2) + 2
    fab, cfgs, ext, depths = workload(n_dev + 3, seed=11, cycles=3)
    want = fab.run_batch(cfgs, ext, depth=depths, shard=False).numpy()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = fab.run_batch(cfgs, ext, depth=depths,
                            _devices=[CPU] * n_dev).numpy()
        build.reset_launch_counts()
        threads = [threading.Thread(target=lambda: [
            build.count_launch("hpwl") for _ in range(2000)])
            for _ in range(n_dev)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert build.LAUNCHES["hpwl"] == 2000 * n_dev
    finally:
        sys.setswitchinterval(old)
        build.reset_launch_counts()
    np.testing.assert_array_equal(got, want)

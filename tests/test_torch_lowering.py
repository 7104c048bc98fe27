"""``FabricModule`` in the port against the reference's, on the
``_random_fabric_workload`` workload (random configs, so cyclic ones with
per-lane depths are included): ``run_batch`` unstreamed and streamed,
fused and unfused, and ``step`` / ``run``, all bit-identical; ``step`` /
``run`` also on a routed app of a 6x6 fabric with registers and memory
columns."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compile import compile_spec as ref_compile
from repro.core.lowering import FabricModule as RefFabric
from repro.core.passes import PassManager as RefPassManager
from repro.core.pnr.app import app_pointwise as ref_pointwise
from repro.core.spec import InterconnectSpec as RefSpec
from repro.fabric import AppEmulator as RefEmulator
from repro_torch import interop
from repro_torch.core.compile import compile_spec
from repro_torch.core.lowering import PE_OP_IDS, FabricModule
from repro_torch.core.passes import PassManager
from repro_torch.core.pnr.app import app_pointwise
from repro_torch.core.spec import InterconnectSpec
from repro_torch.fabric import AppEmulator

SPEC = dict(width=4, height=4, num_tracks=2, io_ring=True,
            sb_type="wilton", reg_density=1.0)


@functools.lru_cache(maxsize=None)
def _fabrics(use_kernels):
    ref_fab = RefFabric(RefPassManager().run(RefSpec(**SPEC)),
                        use_pallas=use_kernels)
    fab = FabricModule(PassManager().run(InterconnectSpec(**SPEC)),
                       device="cpu", use_kernels=use_kernels)
    return ref_fab, fab


def _workload(fab, seed, batch=4, cycles=5, programs=False):
    """``dse._random_fabric_workload``'s draws, optionally with random PE
    programs (ops, constants, immediates) as well."""
    rng = np.random.default_rng(seed)
    cfgs = rng.integers(0, 4, (batch, fab.num_config)).astype(np.int32)
    ext = rng.integers(0, 256, (batch, cycles, fab.num_io)).astype(np.int32)
    pe = None
    if programs:
        p = max(fab.num_pe, 1)
        pe = {"op": rng.integers(0, len(PE_OP_IDS), (batch, p)),
              "const": rng.integers(-300, 70000, (batch, p)),
              "imm_mask": (rng.random((batch, p, 4)) < 0.3),
              "imm_val": rng.integers(-9, 1 << 17, (batch, p, 4))}
        pe = {k: v.astype(np.int32) for k, v in pe.items()}
    return cfgs, ext, pe


def _run_both(use_kernels, seed, programs=False, **kw):
    ref_fab, fab = _fabrics(use_kernels)
    cfgs, ext, pe = _workload(fab, seed, programs=programs)
    ref_pe = None if pe is None else {k: jnp.asarray(v)
                                      for k, v in pe.items()}
    want = np.asarray(ref_fab.run_batch(jnp.asarray(cfgs), jnp.asarray(ext),
                                        pe_cfgs=ref_pe, **kw))
    got = fab.run_batch(cfgs, ext, pe_cfgs=pe, **kw)
    return got, want, cfgs


@pytest.mark.parametrize("seed,programs", [(0, False), (1, True)])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["oracle", "kernel_path"])
def test_run_batch_matches_reference(use_kernels, seed, programs):
    got, want, cfgs = _run_both(use_kernels, seed, programs)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ref_fab, fab = _fabrics(use_kernels)
    assert [fab.combinational_depth(c) for c in cfgs] == \
        [ref_fab.combinational_depth(c) for c in cfgs]


@pytest.mark.parametrize("io_chunk", [2, 8])
def test_run_batch_streamed_matches_reference(io_chunk):
    """``io_chunk`` on the kernel path: one ``fabric_fused_run`` call
    (plain version here) vs the reference's Pallas streamed kernel in
    interpret mode."""
    got, want, _ = _run_both(True, 2, programs=True, io_chunk=io_chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    unstreamed, _, _ = _run_both(True, 2, programs=True)
    assert torch.equal(got, unstreamed)


def test_run_batch_unfused_matches_reference():
    got, want, _ = _run_both(False, 3, programs=True, fused=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_run_batch_unfused_kernel_path_matches_reference():
    """``fused=False`` with ``use_kernels``: one ``fabric_sweep_batch``
    call per sweep (plain version here) vs the reference's Pallas
    ``fabric_sweep_batch`` in interpret mode."""
    got, want, _ = _run_both(True, 6, programs=True, fused=False)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,depth", [(7, 4), (8, 5)])
def test_step_and_run_kernel_path_match_reference(seed, depth):
    """``step``/``run`` with ``use_kernels``: one ``fabric_sweep`` call
    per sweep (plain version here) vs the reference's Pallas
    ``fabric_sweep`` in interpret mode, with PE programs; ``step`` over
    three cycles, its state carried (an even and an odd depth: the
    sweeps end in either value buffer)."""
    ref_fab, fab = _fabrics(True)
    cfgs, ext, pe = _workload(fab, seed, programs=True, cycles=3)
    pe_b = {k: v[1] for k, v in pe.items()}
    want = np.asarray(ref_fab.run(
        jnp.asarray(cfgs[1]), jnp.asarray(ext[1]),
        pe_cfg={k: jnp.asarray(v) for k, v in pe_b.items()}))
    got = fab.run(cfgs[1], ext[1],
                  pe_cfg={k: torch.as_tensor(v) for k, v in pe_b.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    st_ref, st = ref_fab.init_state(), fab.init_state()
    for t in range(3):
        st_ref, obs_ref = ref_fab.step(
            st_ref, jnp.asarray(ext[0, t]), jnp.asarray(cfgs[0]),
            pe_cfg={k: jnp.asarray(v[0]) for k, v in pe.items()},
            depth=depth)
        st, obs = fab.step(st, ext[0, t], cfgs[0],
                           pe_cfg={k: torch.as_tensor(v[0])
                                   for k, v in pe.items()}, depth=depth)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(obs_ref))
        for k in st_ref:
            np.testing.assert_array_equal(st[k].numpy(),
                                          np.asarray(st_ref[k]))


ROUTED_SPEC = dict(width=6, height=6, num_tracks=4, io_ring=True,
                   sb_type="wilton", reg_density=1.0, mem_columns=(3,))


@functools.lru_cache(maxsize=None)
def _routed_pointwise():
    """The reference's pointwise app routed on a 6x6 fabric with a memory
    column, carried into the port through its node keys."""
    ref = ref_compile(RefSpec(**ROUTED_SPEC))
    r = ref.place_and_route(ref_pointwise(3), alphas=(2.0,), sa_steps=40,
                            sa_batch=8)
    assert r.success, r.error
    nodes = r.routing.resources.nodes
    nets = [(net.name, nodes[net.src].node_key(),
             [nodes[s].node_key() for s in net.sinks],
             [(nodes[p].node_key(), nodes[c].node_key())
              for p, c in net.edges()]) for net in r.routing.nets]
    port = compile_spec(InterconnectSpec(**ROUTED_SPEC), device="cpu")
    mine = interop.pnr_result(port.interconnect, app_pointwise(3),
                              r.placement, nets, resources=port.resources())
    return ref, r, port, mine


@pytest.mark.parametrize("config", ["routed", "random"])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["oracle", "kernel_path"])
def test_step_and_run_routed_app_match_reference(use_kernels, config):
    """A routed ``pointwise`` on 6x6 with registers and a memory column,
    and the same fabric under random mux selects with the app's PE
    program (which carry words into the memories): ``run`` over 10
    cycles of random stimulus and ``step`` over 4, state carried,
    bit-identical to the reference (its Pallas ``fabric_sweep`` in
    interpret mode on the kernel path)."""
    ref, r, port, mine = _routed_pointwise()
    ref_fab, fab = ref.fabric(use_kernels), port.fabric(use_kernels)
    assert fab.num_mem and len(fab.arrays.reg_ids)
    ref_emu = RefEmulator.from_pnr(ref_fab, r.packed, r)
    emu = AppEmulator.from_pnr(fab, mine.packed, mine)
    assert emu.depth == ref_emu.depth
    np.testing.assert_array_equal(emu.config.numpy(),
                                  np.asarray(ref_emu.config))
    rng = np.random.default_rng(9)
    cfg, depth = emu.config.numpy(), emu.depth
    if config == "random":
        cfg, depth = rng.integers(0, 4, fab.num_config).astype(np.int32), 7
    ext = rng.integers(0, 1 << 16, (10, fab.num_io)).astype(np.int32)
    want = np.asarray(ref_fab.run(jnp.asarray(cfg), jnp.asarray(ext),
                                  pe_cfg=ref_emu.pe_cfg, depth=depth))
    got = fab.run(cfg, ext, pe_cfg=emu.pe_cfg, depth=depth)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()
    st_ref, st = ref_fab.init_state(), fab.init_state()
    for t in range(4):
        st_ref, obs_ref = ref_fab.step(st_ref, jnp.asarray(ext[t]),
                                       jnp.asarray(cfg), ref_emu.pe_cfg,
                                       depth=depth)
        st, obs = fab.step(st, ext[t], cfg, emu.pe_cfg, depth=depth)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(obs_ref))
        for k in st_ref:
            np.testing.assert_array_equal(st[k].numpy(),
                                          np.asarray(st_ref[k]))
    assert np.asarray(st_ref["regs"]).any()
    if config == "random":
        assert np.asarray(st_ref["mem"]).any()


def test_step_and_run_plain_branch_match_reference():
    ref_fab, fab = _fabrics(False)
    cfgs, ext, pe = _workload(fab, 4, programs=True)
    for b in range(2):
        pe_b = {k: v[b] for k, v in pe.items()}
        want = np.asarray(ref_fab.run(
            jnp.asarray(cfgs[b]), jnp.asarray(ext[b]),
            pe_cfg={k: jnp.asarray(v) for k, v in pe_b.items()}))
        got = fab.run(cfgs[b], ext[b],
                      pe_cfg={k: torch.as_tensor(v) for k, v in pe_b.items()})
        np.testing.assert_array_equal(got.numpy(), want)
    st_ref, obs_ref = ref_fab.step(ref_fab.init_state(),
                                   jnp.asarray(ext[0, 0]),
                                   jnp.asarray(cfgs[0]), depth=5)
    st, obs = fab.step(fab.init_state(), ext[0, 0], cfgs[0], depth=5)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(obs_ref))
    for k in st_ref:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(st_ref[k]))


def test_shard_true_and_unported_sweeps_raise_on_cuda(monkeypatch):
    """``shard=True`` across several GPUs splits the batch over every
    card (``cuda:0`` to ``cuda:3`` here), never falling back to the
    module's one device. The sweeps are ported: under ``use_kernels``
    on CUDA they go to the ``fabric_sweep`` / ``fabric_sweep_batch``
    wrappers (which launch the kernel or raise), never to a plain
    PyTorch path of the fabric's own."""
    from repro_torch.kernels import ops as kops

    _, fab = _fabrics(True)
    cfgs, ext, _ = _workload(fab, 5)
    cyc = fab._cycle(cfgs[0], None)
    fab._sweep(cyc, *cyc["vals"])        # the device tables, on the CPU
    fab_cuda = object.__new__(FabricModule)
    fab_cuda.__dict__.update(fab.__dict__)
    fab_cuda.device = torch.device("cuda")
    n = fab.arrays.num_nodes
    calls = []

    def fake(name):
        def kernel(vals_ext, src, sel, out=None):
            calls.append((name, tuple(vals_ext.shape), src.dtype,
                          None if out is None else tuple(out.shape)))
            raise RuntimeError(f"{name}: no card")
        return kernel

    monkeypatch.setattr(kops, "fabric_sweep", fake("fabric_sweep"))
    monkeypatch.setattr(kops, "fabric_sweep_batch",
                        fake("fabric_sweep_batch"))
    with pytest.raises(RuntimeError, match="fabric_sweep_batch: no card"):
        fab_cuda._sweep_batch(torch.zeros((1, n + 1), dtype=torch.int32),
                              torch.zeros((1, n), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="fabric_sweep: no card"):
        fab_cuda._sweep(cyc, *cyc["vals"])
    assert calls == [("fabric_sweep_batch", (1, n + 1), torch.int32, None),
                     ("fabric_sweep", (n + 1,), torch.int32, (n,))]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    split = []

    def fake_split(devices, *args):
        split.append(devices)
        raise RuntimeError("split: no card")

    monkeypatch.setattr(fab_cuda, "_ints", lambda x: torch.as_tensor(
        np.asarray(x, dtype=np.int32)))
    monkeypatch.setattr(fab_cuda, "_run_batch_split", fake_split)
    for shard in (True, None):
        with pytest.raises(RuntimeError, match="split: no card"):
            fab_cuda.run_batch(cfgs, ext, shard=shard, depth=3,
                               pe_cfgs=fab.default_pe_cfg_batch(len(cfgs)))
    assert split == [[torch.device("cuda", i) for i in range(4)]] * 2

"""The whole slice on ``smoke()`` — compile -> PnR -> bitstream ->
batched emulation — with ``device="cpu", use_kernels=True`` (the kernel
wrappers' plain versions), against the reference on the same routing."""
import functools

import numpy as np
import pytest

from repro.configs.cgra_amber import smoke as ref_smoke
from repro.core.compile import compile_spec as ref_compile
from repro.core.pnr.app import BENCH_APPS as REF_APPS
from repro.fabric import AppEmulator as RefEmulator
from repro.fabric import run_apps_batch as ref_run_apps_batch
from repro_torch import interop
from repro_torch.configs.cgra_amber import smoke
from repro_torch.core.bitstream import deserialize, serialize
from repro_torch.core.compile import compile_spec
from repro_torch.core.pnr.app import (BENCH_APPS, app_pointwise,
                                      app_tree_reduce)
from repro_torch.core.spec import InterconnectSpec
from repro_torch.fabric import AppEmulator, run_apps_batch

PNR = dict(alphas=(2.0,), sa_steps=40, sa_batch=8)
T = 12


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's routed bench apps on smoke(), with its bitstreams
    and its batched emulation of all of them."""
    fab = ref_compile(ref_smoke())
    routed = {}
    for name, make in REF_APPS.items():
        r = fab.place_and_route(make(), **PNR)
        if r.success:                # stencil needs memory columns
            routed[name] = r
    emus = [RefEmulator.from_pnr(fab.fabric(), r.packed, r)
            for r in routed.values()]
    ins = [_stimulus(r) for r in routed.values()]
    outs = ref_run_apps_batch(emus, ins, T)
    words = {n: fab.bitstream(r) for n, r in routed.items()}
    return routed, words, outs, [e.depth for e in emus]


def _stimulus(r):
    return {r.placement[n]: np.arange(1, T + 1, dtype=np.int32) * (k + 1)
            for k, (n, inst) in enumerate(sorted(r.packed.placeable.items()))
            if inst.kind == "io_in"}


def _nets(r):
    nodes = r.routing.resources.nodes
    return [(net.name, nodes[net.src].node_key(),
             [nodes[s].node_key() for s in net.sinks],
             [(nodes[p].node_key(), nodes[c].node_key())
              for p, c in net.edges()])
            for net in r.routing.nets]


@functools.lru_cache(maxsize=None)
def _port():
    fab = compile_spec(smoke(), device="cpu", use_kernels=True)
    routed, _, _, _ = _reference()
    mine = {name: interop.pnr_result(fab.interconnect, BENCH_APPS[name](),
                                     r.placement, _nets(r),
                                     resources=fab.resources())
            for name, r in routed.items()}
    return fab, mine


def test_reference_routes_the_bench_apps():
    routed, _, _, _ = _reference()
    assert {"pointwise", "tree_reduce", "fir", "butterfly"} <= set(routed)


def test_bitstream_words_equal_reference():
    _, ref_words, _, _ = _reference()
    fab, mine = _port()
    for name, r in mine.items():
        words = fab.bitstream(r)
        assert [(w.addr, w.data) for w in words] == \
            [(w.addr, w.data) for w in ref_words[name]], name
        assert deserialize(serialize(words)) == words


@pytest.mark.parametrize("io_chunk", [None, 4])
def test_run_apps_batch_equals_reference(io_chunk):
    _, _, ref_outs, ref_depths = _reference()
    fab, mine = _port()
    emus = [AppEmulator.from_pnr(fab.fabric(), r.packed, r)
            for r in mine.values()]
    assert [e.depth for e in emus] == ref_depths
    outs = run_apps_batch(emus, [_stimulus(r) for r in mine.values()], T,
                          io_chunk=io_chunk)
    assert len(outs) == len(ref_outs)
    for got, want in zip(outs, ref_outs):
        assert got.keys() == want.keys()
        for coord in want:
            np.testing.assert_array_equal(got[coord], np.asarray(want[coord]))


@functools.lru_cache(maxsize=None)
def _golden_fabric():
    spec = InterconnectSpec(width=6, height=6, num_tracks=4,
                            sb_type="wilton", io_ring=True, reg_density=1.0)
    return compile_spec(spec, device="cpu", use_kernels=True)


def test_pointwise_chain_golden():
    """``tests/test_fabric_e2e.py``'s golden check, through the port's
    own PnR and its batched kernel path: out = in + 1 + 2 + 3."""
    fab = _golden_fabric()
    r = fab.place_and_route(app_pointwise(3), **PNR)
    assert r.success, r.error
    x = np.arange(20, 20 + 16).astype(np.int32)
    emu = AppEmulator.from_pnr(fab.fabric(), r.packed, r)
    for outs in (emu.run({r.placement["in0"]: x}, 16),
                 run_apps_batch([emu], [{r.placement["in0"]: x}], 16)[0]):
        y = outs[r.placement["out0"]]
        nz = np.nonzero(y)[0]
        assert len(nz), "no output observed"
        np.testing.assert_array_equal(y[nz[0]:nz[0] + 8], x[:8] + 6)


def test_tree_reduce_golden():
    fab = _golden_fabric()
    r = fab.place_and_route(app_tree_reduce(4), **PNR)
    assert r.success, r.error
    ins = {r.placement[f"in{i}"]: np.full(16, 7 * (i + 1), np.int32)
           for i in range(4)}
    outs = fab.emulate(r, ins, 16)
    assert outs[r.placement["out0"]][-1] == 7 * (1 + 2 + 3 + 4)

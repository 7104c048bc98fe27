"""The port's ready-valid fabric (``RVFabric``) against the reference.

The same inputs, made with numpy from a seed, go through
``repro.fabric.ready_valid`` and ``repro_torch.fabric.ready_valid`` on
the CPU, in both FIFO modes; integer work, so every trace must be
bit-identical. The reference's own RV properties (losslessness, ready
reaching the source, token conservation, full buffering more than split)
are re-stated on the port, the deadlocked FIFO ring of the routed
analysis is carried across through ``interop``, and a routed 6x6 design
point gives equal bitstream words and an equal handshake trace.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import canal
import canal_torch
from repro.core.compile import compile_spec as ref_compile
from repro.core.edsl import create_uniform_interconnect as ref_uniform
from repro.core.pnr.app import app_pointwise as ref_pointwise
from repro.core.spec import InterconnectSpec as RefSpec
from repro.fabric import AppEmulator as RefEmulator
from repro.fabric import run_apps_batch as ref_run_apps_batch
from repro.fabric.ready_valid import compile_ready_valid as ref_rv
from repro_torch import interop
from repro_torch.core.edsl import create_uniform_interconnect
from repro_torch.core.pnr.app import app_pointwise
from repro_torch.fabric import (AppEmulator, RVFabric, compile_ready_valid,
                                east_route, run_apps_batch)
from test_lowering_fabric import manual_east_route
from test_routed_analysis import _find_cycle, _ring_artifacts, _rv_fifo_ids

MODES = ("full", "split")
RV_IC = dict(width=4, height=4, num_tracks=2, sb_type="wilton",
             io_ring=True, reg_density=1.0, ready_valid=True)
SRC, DST = (0, 1), (3, 1)


@functools.lru_cache(maxsize=None)
def _fabrics(mode):
    """The reference's and the port's RV fabric on ``RV_IC``, with the
    east route's configuration (the same IR, so the same vector)."""
    ref = ref_rv(ref_uniform(**RV_IC), fifo_mode=mode)
    fab = compile_ready_valid(create_uniform_interconnect(**RV_IC),
                              fifo_mode=mode, device="cpu")
    config = fab.route_to_config(east_route(fab.ic))
    np.testing.assert_array_equal(
        config, ref.route_to_config(manual_east_route(ref.ic)))
    return ref, fab, config


def _io(fab):
    return {c: i for i, c in enumerate(fab.io_coords)}


def _schedule(fab, kind, seed=0, t_len=28, n_items=10):
    """Sources and sink backpressure of ``tests/test_ready_valid.py``:
    ``lossless`` (an 8-cycle stall), ``never`` (the sink never ready),
    ``random`` (~50% stalls over the first cycles, then a drain)."""
    io = _io(fab)
    src, dst = io[SRC], io[DST]
    streams = np.zeros((t_len, fab.num_io), np.int32)
    lens = np.zeros(fab.num_io, np.int32)
    streams[:n_items, src] = np.arange(1, n_items + 1)
    lens[src] = n_items
    sink = np.ones((t_len, fab.num_io), np.int32)
    if kind == "lossless":
        sink[3:11, dst] = 0
    elif kind == "never":
        sink[:] = 0
    else:
        stall = t_len - 14
        sink[:stall, dst] = (np.random.default_rng(seed).random(stall)
                             < 0.5).astype(np.int32)
    return streams, lens, sink


def _received(fab, outs):
    od, ov, acc = (np.asarray(o) for o in outs)
    j = _io(fab)[DST]
    return list(od[:, j][acc[:, j] > 0])


# ------------------------------------------------------------ the fabric
def test_compile_builds_rvfabric_in_the_ir_mode():
    """``fabric()`` on a ready-valid spec is the port's ``RVFabric`` in the
    mode the IR annotation names (``full`` unless ``split_fifo``), its
    tables equal to the reference's; ``verify()`` still raises."""
    for split, mode in ((False, "full"), (True, "split")):
        spec = dict(width=4, height=4, num_tracks=2, io_ring=True,
                    reg_density=1.0, ready_valid=True, split_fifo=split)
        ref = canal.compile(RefSpec(**spec)).fabric()
        port = canal_torch.compile(canal_torch.InterconnectSpec(**spec),
                                   device="cpu")
        fab = port.fabric()
        assert isinstance(fab, RVFabric) and port.fabric() is fab
        assert (fab.fifo_mode, fab.fifo_depth) == (mode, ref.fifo_depth)
        assert ref.fifo_mode == mode
        interop.check_tables(fab, {k: v for k, v in
                                   interop.fabric_tables(ref).items()})
        for name in ("cons", "cons_idx", "reg_slot", "is_reg_arr"):
            np.testing.assert_array_equal(getattr(fab, name),
                                          getattr(ref, name))
        assert fab.max_cons == ref.max_cons
        with pytest.raises(NotImplementedError):
            port.verify()


def test_unknown_fifo_mode_raises():
    with pytest.raises(ValueError, match="fifo_mode"):
        compile_ready_valid(create_uniform_interconnect(**RV_IC),
                            fifo_mode="deep", device="cpu")


# ------------------------------------------------------- traces, bit for bit
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["lossless", "never", "random"])
def test_run_with_sources_matches_reference(mode, kind):
    ref, fab, config = _fabrics(mode)
    streams, lens, sink = _schedule(fab, kind, seed=7)
    want = ref.run_with_sources(jnp.asarray(config), jnp.asarray(streams),
                                jnp.asarray(lens), jnp.asarray(sink),
                                depth=20)
    got = fab.run_with_sources(config, streams, lens, sink, depth=20)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if kind != "never":
        assert _received(fab, got) == list(range(1, 11))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["lossless", "never", "random"])
def test_run_stream_matches_reference(mode, kind):
    """Free-running sources (valid whenever they hold an item, whatever
    the fabric's ready): io_data, io_valid and io_ready per cycle."""
    ref, fab, config = _fabrics(mode)
    streams, _, sink = _schedule(fab, kind, seed=11)
    valid = (streams > 0).astype(np.int32)
    want = ref.run_stream(jnp.asarray(config), jnp.asarray(streams),
                          jnp.asarray(valid), jnp.asarray(sink), depth=20)
    got = fab.run_stream(config, streams, valid, sink, depth=20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[2]).any()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("config_kind", ["east", "random"])
def test_step_state_matches_reference(mode, config_kind):
    """``step`` cycle by cycle, state carried: every cycle's FIFO
    ``slots`` and ``occ`` and outputs equal the reference's. ``random``
    drives random selects (cyclic ones included), a random PE program and
    random valid and backpressure on every IO, so that PE valid, the
    consumer join and both FIFO modes see many paths at once."""
    ref, fab, config = _fabrics(mode)
    rng = np.random.default_rng(3 if mode == "full" else 4)
    pe_cfg, depth = None, 20
    if config_kind == "random":
        config = rng.integers(0, 4, fab.num_config).astype(np.int32)
        n = max(fab.num_pe, 1)
        pe_cfg = {"op": rng.integers(0, 14, n), "const": rng.integers(
            0, 1 << 16, n), "imm_mask": rng.random((n, 4)) < 0.3,
            "imm_val": rng.integers(0, 1 << 16, (n, 4))}
        pe_cfg = {k: v.astype(np.int32) for k, v in pe_cfg.items()}
        depth = 9
    ref_pe = (None if pe_cfg is None
              else {k: jnp.asarray(v) for k, v in pe_cfg.items()})
    st_ref, st = ref.init_state(), fab.init_state()
    ref_step = jax.jit(ref.step, static_argnames=("depth",))
    moved = 0
    for _ in range(12):
        ext = rng.integers(0, 1 << 16, fab.num_io).astype(np.int32)
        valid = (rng.random(fab.num_io) < 0.7).astype(np.int32)
        sink = (rng.random(fab.num_io) < 0.6).astype(np.int32)
        st_ref, want = ref_step(st_ref, jnp.asarray(ext), jnp.asarray(valid),
                                jnp.asarray(config), ref_pe,
                                ext_sink_ready=jnp.asarray(sink),
                                depth=depth)
        st, got = fab.step(st, ext, valid, config, pe_cfg,
                           ext_sink_ready=sink, depth=depth)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        mine = interop.rv_state_to_numpy(st)
        for k in interop.RV_STATE_KEYS:
            np.testing.assert_array_equal(mine[k], np.asarray(st_ref[k]))
        moved += int(np.asarray(st_ref["occ"]).sum())
    assert moved > 0


# ------------------------------------------ the reference's RV properties
@pytest.mark.parametrize("mode", MODES)
def test_lossless_under_backpressure(mode):
    _, fab, config = _fabrics(mode)
    streams, lens, sink = _schedule(fab, "lossless")
    got = fab.run_with_sources(config, streams, lens, sink, depth=20)
    assert _received(fab, got) == list(range(1, 11)), mode


@pytest.mark.parametrize("mode", MODES)
def test_ready_propagates_to_source(mode):
    """With the sink always stalled, source ready drops: the fabric
    absorbs only as many items as its FIFO stages hold."""
    _, fab, config = _fabrics(mode)
    t_len = 20
    streams, lens, sink = _schedule(fab, "never", t_len=t_len,
                                    n_items=t_len)
    valid = (streams > 0).astype(np.int32)
    od, ov, orr = fab.run_stream(config, streams, valid, sink, depth=20)
    src = _io(fab)[SRC]
    absorbed = int(orr[:, src].sum())
    # three FIFO stages on the route, plus the sink's io port
    assert 0 < absorbed <= (8 if mode == "full" else 5)
    assert orr[-1, src] == 0
    acc = fab.run_with_sources(config, streams, lens, sink, depth=20)[2]
    assert int(acc.sum()) == 0
    assert int(ov[:, _io(fab)[DST]].max()) <= 1


@pytest.mark.parametrize("mode", MODES)
@given(st.integers(1, 8), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=4, deadline=None)
def test_token_conservation_random_backpressure(mode, n_items, seed):
    """Every injected token arrives exactly once, in order, under a random
    stall schedule followed by a drain."""
    _, fab, config = _fabrics(mode)
    streams, lens, sink = _schedule(fab, "random", seed=seed, t_len=40,
                                    n_items=n_items)
    got = fab.run_with_sources(config, streams, lens, sink, depth=20)
    assert _received(fab, got) == list(range(1, n_items + 1)), (mode, seed)


def test_full_mode_buffers_more_than_split():
    absorbed = {}
    for mode in MODES:
        _, fab, config = _fabrics(mode)
        streams, _, sink = _schedule(fab, "never", t_len=16, n_items=16)
        valid = (streams > 0).astype(np.int32)
        orr = fab.run_stream(config, streams, valid, sink, depth=20)[2]
        absorbed[mode] = int(orr[:, _io(fab)[SRC]].sum())
    assert absorbed["full"] > absorbed["split"]


# -------------------------------------------- the deadlocked FIFO ring
def test_full_fifo_ring_stays_full_as_in_reference():
    """``tests/test_routed_analysis.py``'s deadlock scenario: a routed ring
    through FIFO stages, each preloaded to capacity in the reference's
    state, carried into the port through ``interop``; five cycles later
    every stage is still full on both, their states equal."""
    spec = dict(width=4, height=4, num_tracks=2, io_ring=True,
                reg_density=1.0, ready_valid=True)
    ref_fab = canal.compile(RefSpec(**spec))
    res = ref_fab.resources()
    fifo = set(_rv_fifo_ids(res))
    ring = _find_cycle(res, sorted(fifo), lambda v: True)
    fifo_ids = [i for i in ring if i in fifo]
    _, routing = _ring_artifacts(res, ring)
    ref = ref_fab.fabric()
    config = np.asarray(ref.route_to_config(
        [(res.nodes[p], res.nodes[c])
         for c, p in routing.nets[0].tree.items()]))
    state = ref.init_state()
    slots = [int(ref.reg_slot[ref.node_id[res.nodes[i]]]) for i in fifo_ids]
    for s in slots:
        state["occ"] = state["occ"].at[s].set(ref.fifo_depth)
        state["slots"] = state["slots"].at[s].set(jnp.full((2,), 7,
                                                           jnp.int32))
    fab = canal_torch.compile(canal_torch.InterconnectSpec(**spec),
                              device="cpu").fabric()
    assert fab.fifo_depth == 2
    mine = interop.rv_state_from_numpy(
        fab, {k: np.asarray(v) for k, v in state.items()})
    zeros = np.zeros(fab.num_io, np.int32)
    for _ in range(5):
        state, _ = ref.step(state, jnp.asarray(zeros), jnp.asarray(zeros),
                            jnp.asarray(config))
        mine, _ = fab.step(mine, zeros, zeros, config)
        got = interop.rv_state_to_numpy(mine)
        for k in interop.RV_STATE_KEYS:
            np.testing.assert_array_equal(got[k], np.asarray(state[k]))
        assert all(int(got["occ"][s]) == 2 for s in slots)


def test_rv_state_interop_round_trip():
    _, fab, _ = _fabrics("full")
    rng = np.random.default_rng(0)
    r = len(fab.arrays.reg_ids)
    state = {"slots": rng.integers(0, 99, (r, 2)),
             "occ": rng.integers(0, 3, r), "mem": np.zeros(1)}
    got = interop.rv_state_to_numpy(interop.rv_state_from_numpy(fab, state))
    for k in interop.RV_STATE_KEYS:
        np.testing.assert_array_equal(got[k], state[k])
        assert got[k].dtype == np.int32


# ------------------------------------------------- a routed design point
ROUTED_RV = dict(width=6, height=6, num_tracks=4, io_ring=True,
                 reg_density=1.0, ready_valid=True)


@functools.lru_cache(maxsize=None)
def _routed_rv():
    """The reference's pointwise app routed on a 6x6 RV point (full
    FIFOs), carried into the port through its node keys."""
    ref = ref_compile(RefSpec(**ROUTED_RV))
    r = ref.place_and_route(ref_pointwise(), alphas=(2.0,), sa_steps=30,
                            sa_batch=8)
    assert r.success, r.error
    nodes = r.routing.resources.nodes
    nets = [(net.name, nodes[net.src].node_key(),
             [nodes[s].node_key() for s in net.sinks],
             [(nodes[p].node_key(), nodes[c].node_key())
              for p, c in net.edges()]) for net in r.routing.nets]
    port = canal_torch.compile(canal_torch.InterconnectSpec(**ROUTED_RV),
                               device="cpu")
    mine = interop.pnr_result(port.interconnect, app_pointwise(), r.placement,
                              nets, resources=port.resources())
    return ref, r, port, mine


def test_routed_rv_bitstream_and_trace_match_reference():
    """Equal bitstream words, and a 16-cycle ``run_with_sources`` of the
    app's configuration and PE program under random backpressure,
    bit-identical. The reference fires a PE on its a AND b valid only,
    and pointwise's b ports carry packed constants, not routes: no token
    reaches the sink on either package, while the source is taken every
    cycle even under a sink that is never ready."""
    ref, r, port, mine = _routed_rv()
    words = port.bitstream(mine)
    assert words and [(w.addr, w.data) for w in words] == \
        [(w.addr, w.data) for w in ref.bitstream(r)]
    ref_fab, fab = ref.fabric(), port.fabric()
    ref_emu = RefEmulator.from_pnr(ref_fab, r.packed, r)
    emu = AppEmulator.from_pnr(fab, mine.packed, mine)
    assert emu.depth == ref_emu.depth
    np.testing.assert_array_equal(emu.config.numpy(),
                                  np.asarray(ref_emu.config))
    io = _io(fab)
    src, dst = io[r.placement["in0"]], io[r.placement["out0"]]
    t_len, n_items = 16, 12
    rng = np.random.default_rng(5)
    streams = np.zeros((t_len, fab.num_io), np.int32)
    lens = np.zeros(fab.num_io, np.int32)
    streams[:n_items, src] = rng.integers(1, 1 << 16, n_items)
    lens[src] = n_items
    sink = (rng.random((t_len, fab.num_io)) < 0.7).astype(np.int32)
    want = ref_fab.run_with_sources(
        ref_emu.config, jnp.asarray(streams), jnp.asarray(lens),
        jnp.asarray(sink), pe_cfg=ref_emu.pe_cfg, depth=ref_emu.depth)
    got = fab.run_with_sources(emu.config, streams, lens, sink,
                               pe_cfg=emu.pe_cfg, depth=emu.depth)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    od, ov, acc = (np.asarray(w) for w in want)
    assert ov[:, dst].sum() == 0 and acc.sum() == 0
    assert od.any()
    assert mine.packed.const_ports["pe0"]            # b is a constant
    # under a sink never ready the source is still taken every cycle: a
    # PE input port has no consumer, so it reads ready
    valid = (streams > 0).astype(np.int32)
    never = np.zeros_like(sink)
    want = ref_fab.run_stream(ref_emu.config, jnp.asarray(streams),
                              jnp.asarray(valid), jnp.asarray(never),
                              pe_cfg=ref_emu.pe_cfg, depth=ref_emu.depth)
    got = fab.run_stream(emu.config, streams, valid, never,
                         pe_cfg=emu.pe_cfg, depth=emu.depth)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[2].numpy()[:, src] == 1).all()


def test_routed_rv_emulate_runs_the_static_semantics():
    """``emulate()`` on an RV point runs the inherited static model
    (``FabricModule.run``), equal to the reference's batched emulation of
    the same app on its RV fabric, and so does the port's; the
    reference's own ``emulate()`` raises there (``RVFabric.step`` shadows
    the static ``step`` that its ``run`` calls)."""
    ref, r, port, mine = _routed_rv()
    stim = {"in0": np.arange(1, 13, dtype=np.int32)}
    with pytest.raises(TypeError):
        ref.emulate(r, stim, cycles=12)
    got = port.emulate(mine, stim, cycles=12)
    ref_emu = RefEmulator.from_pnr(ref.fabric(), r.packed, r)
    want = ref_run_apps_batch([ref_emu], [{r.placement["in0"]:
                                           stim["in0"]}], 12)[0]
    batched = run_apps_batch([AppEmulator.from_pnr(port.fabric(),
                                                   mine.packed, mine)],
                             [{mine.placement["in0"]: stim["in0"]}], 12)[0]
    assert set(got) == set(want) == set(batched)
    for coord in want:
        np.testing.assert_array_equal(got[coord], np.asarray(want[coord]))
        np.testing.assert_array_equal(batched[coord], got[coord])
    assert np.asarray(want[r.placement["out0"]]).any()


def test_split_mode_needs_sweeps_over_the_whole_ready_chain():
    """A reference behaviour the port keeps: split stages chain ready
    combinationally through every stage of a route, so the backward pass
    needs a sweep an edge. With ``depth_for_route``'s depth (registers
    restart its chains) both packages push into full stages and lose the
    same tokens; with one sweep an edge both deliver every token in
    order. Bit-identical either way."""
    spec = dict(RV_IC, width=6, height=6)
    ref = ref_rv(ref_uniform(**spec), fifo_mode="split")
    fab = compile_ready_valid(create_uniform_interconnect(**spec),
                              fifo_mode="split", device="cpu")
    edges = east_route(fab.ic)
    config = fab.route_to_config(edges)
    io = _io(fab)
    src, dst = io[(0, 1)], io[(5, 1)]
    t_len, n_items = 60, 24
    streams = np.zeros((t_len, fab.num_io), np.int32)
    streams[:n_items, src] = np.arange(1, n_items + 1)
    lens = np.zeros(fab.num_io, np.int32)
    lens[src] = n_items
    sink = (np.random.default_rng(0).random((t_len, fab.num_io))
            < 0.6).astype(np.int32)
    received = {}
    for depth in (fab.depth_for_route(edges), len(edges) + 2):
        want = ref.run_with_sources(jnp.asarray(config), jnp.asarray(streams),
                                    jnp.asarray(lens), jnp.asarray(sink),
                                    depth=depth)
        got = fab.run_with_sources(config, streams, lens, sink, depth=depth)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        od, acc = got[0].numpy(), got[2].numpy()
        received[depth] = list(od[:, dst][acc[:, dst] > 0])
    shallow, whole = received.values()
    assert whole == list(range(1, n_items + 1))
    assert len(shallow) < n_items

"""Amber's 1-bit predicate network in the port: the 1-bit PE and IO ports
a spec with a 1-bit layer gets, 1-bit nets routed on that layer only, the
predicate ops in every emulation engine, and the predicate apps of the
benchmark (``canalbench/apps``) against its plain reference
(``canalbench/reference.py``) on the CPU at the benchmark's small
two-layer array. The ``cuda`` tests hold both variants of the fused
kernels to the eager engine on the card:

    python -m pytest -q -m cuda tests/test_torch_two_layer.py
"""
import functools
import time

import numpy as np
import pytest
import torch

import canal_torch
from canalbench import harness, reference
from canalbench.kinds import app_graph, make_spec
from repro_torch import obs
from repro_torch.core.dse import SweepExecutor
from repro_torch.core.lowering import PRED_OP_IDS
from repro_torch.core.pnr.packing import pack
from repro_torch.core.spec import InterconnectSpec
from repro_torch.fabric import AppEmulator, RVFabric, run_apps_batch
from repro_torch.kernels import cluster_plan, fabric_step, ref

APPS = ["max_tree", "sort4", "threshold", "window"]
PNR = dict(alphas=(2.0,), sa_steps=30, sa_batch=8)
T = 24
BIT_PORTS = {"pe": {"bit0", "bit1", "bit2", "res_p"},
             "io": {"io2f_1", "f2io_1"}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The emulation engines here are thousands of small tensor ops: one
    thread each keeps them quick beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small():
    return harness.load_config("amber_two_layer")["small"]


@functools.lru_cache(maxsize=None)
def _compiled():
    return canal_torch.compile(make_spec({"spec": _small()}), device="cpu")


@functools.lru_cache(maxsize=None)
def _routed(name):
    cf = _compiled()
    r = cf.place_and_route(app_graph(reference.load_app(name)), **PNR)
    assert r.success, r.error
    return r


def _stimulus(name, seed, cycles=T):
    rng = np.random.default_rng([seed, 2 ** 31 + 9])
    return {i: rng.integers(0, 1 << 16, cycles, dtype=np.int64)
            for i in reference.app_ios(reference.load_app(name), "io_in")}


def _check(name, stim, got):
    """``got`` ({io tile: stream}) at the app's outputs equals the
    reference's streams for ``stim``."""
    app = reference.load_app(name)
    r = _routed(name)
    outs = {o: np.asarray(got[tuple(r.placement[o])], np.int64)
            for o in reference.app_ios(app, "io_out")}
    want = reference.evaluate(app, stim)
    for o, w in want.items():
        np.testing.assert_array_equal(outs[o], w, err_msg=f"{name}.{o}")


def _by_tile(name, stim):
    r = _routed(name)
    return {tuple(r.placement[i]): v for i, v in stim.items()}


# ------------------------------------------------------------------ the IR
@pytest.mark.parametrize("layers", [(), ((1, 3),), ((1, 3), (32, 2))])
def test_bit_ports_exist_only_with_a_1_bit_layer(layers):
    spec = InterconnectSpec(**dict(_small(), extra_layers=layers))
    ic = canal_torch.compile(spec, device="cpu", analyze="off").interconnect
    for g in ic.graphs.values():
        for tile in g.tiles.values():
            kind = tile.core_type
            if kind not in BIT_PORTS:
                continue
            names = {p.name for p in tile.core.ports}
            assert (BIT_PORTS[kind] & names) == (
                BIT_PORTS[kind] if layers else set())
            for p in tile.core.ports:
                node = tile.ports[p.name]
                # a port is wired in its own width's layer only
                wired = node.fan_in or node.fan_out
                assert bool(wired) == (p.width == g.width), (p, g.width)


def test_two_layer_fabric_has_bit_inputs_and_io_pairs():
    fab = _compiled().fabric()
    assert fab.pred and fab.pe_in.shape == (fab.num_pe, 7)
    assert fab.pe_out.shape == (fab.num_pe, 3)
    assert [fab.nodes[i].width for i in fab.pe_in[0]] == [16] * 4 + [1] * 3
    assert [fab.nodes[i].port_name for i in fab.pe_out[0]] == [
        "res0", "res1", "res_p"]
    tiles = fab.num_io // 2
    assert fab.io_ports == [("io_out", "io_in")] * tiles + [
        ("io2f_1", "f2io_1")] * tiles
    assert fab.io_coords[:tiles] == fab.io_coords[tiles:]
    assert list(fab.io_in_mask) == [0xFFFF] * tiles + [1] * tiles
    one = canal_torch.compile(make_spec({"spec": _small()},
                                        extra_layers=()), device="cpu")
    plain = one.fabric()
    assert not plain.pred and plain.pe_in.shape[1] == 4
    assert plain.io_ports == [("io_out", "io_in")] * plain.num_io


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("name", APPS)
def test_each_net_routes_on_its_ports_layer(name):
    obs_since = obs.spans()[-1].t1 if obs.spans() else None
    r = _compiled().place_and_route(app_graph(reference.load_app(name)),
                                    **PNR)
    assert r.success, r.error
    widths = reference.load_app(name)["widths"]
    res = r.routing.resources
    assert len(r.packed.nets) == len(r.routing.nets)
    n_1b = 0
    for net, routed in zip(r.packed.nets, r.routing.nets):
        want = widths.get(net.src[1], 16)
        used = {res.nodes[i].width for i in routed.nodes_used()}
        assert used == {want}, (name, net.src, used)
        n_1b += want == 1
    assert n_1b > 0
    spans = [s for s in obs.spans("pnr.route", since=obs_since)
             if "nets_1b" in s.attrs]
    assert spans and spans[-1].attrs["nets_1b"] == n_1b


def test_a_net_joining_two_widths_raises():
    app = reference.load_app("window")
    bad = dict(app, nets=[n if n[0] != ["v", "res_p"] else
                          [["v", "res_p"], [["y", "data0"]]]
                          for n in app["nets"]])
    with pytest.raises(ValueError, match="1 bit"):
        _compiled().place_and_route(app_graph(bad), **PNR)


def test_a_constant_into_bit0_is_refused_and_data0_keeps_its_slot():
    app = reference.load_app("threshold")
    packed = pack(app_graph(app))
    assert packed.const_ports["ge0"] == {"data1": 0x4000}
    assert packed.const_ports["sel0"] == {"data1": 0}
    bad = dict(app, nets=[n if n[0] != ["zero0", "out"] else
                          [["zero0", "out"], [["sel0", "bit0"]]]
                          for n in app["nets"]])
    with pytest.raises(ValueError, match="'bit0'"):
        pack(app_graph(bad))
    # the PE program: data1's immediate in slot 1, data0's slot empty
    r = _routed("threshold")
    emu = AppEmulator.from_pnr(_compiled().fabric(), r.packed, r)
    pe = _compiled().fabric().pe_coords.index(tuple(r.placement["sel0"]))
    assert emu.pe_cfg["imm_mask"][pe].tolist() == [0, 1, 0, 0]


# --------------------------------------------------------------- emulation
@pytest.mark.parametrize("name", APPS)
def test_every_engine_equals_the_reference(name):
    """The eager engine (``run``, sweep by sweep: plain gathers and the
    sweep's plain version), ``run_batch`` unfused, fused (the scatter
    oracle and the fused kernel's plain version) and streamed (the run
    kernel's plain version) all give the reference's streams."""
    stim = _stimulus(name, 5)
    ins = _by_tile(name, stim)
    cf, r = _compiled(), _routed(name)
    for use_kernels in (False, True):
        fab = cf.fabric(use_kernels=use_kernels)
        emu = AppEmulator.from_pnr(fab, r.packed, r)
        _check(name, stim, emu.run(ins, T))
        for kw in ({"fused": False}, {}, {"io_chunk": 4}):
            ext = torch.as_tensor(emu.ext_stream(ins, T))[None]
            obs_ = fab.run_batch(emu.config[None], ext,
                                 pe_cfgs={k: v[None] for k, v in
                                          emu.pe_cfg.items()},
                                 depth=[emu.depth], **kw)[0].numpy()
            _check(name, stim, {c: obs_[:, i]
                                for c, i in emu.io_index.items()})


def test_a_batch_of_every_app_equals_the_reference():
    """Both fused modes on the CPU, where the fused kernels' plain
    versions run: their ``emu.fused`` spans say no kernel and no
    cluster ran."""
    fab = _compiled().fabric(use_kernels=True)
    emus, ins, stims = [], [], []
    for k, name in enumerate(APPS * 2):
        r = _routed(name)
        emus.append(AppEmulator.from_pnr(fab, r.packed, r))
        stims.append(_stimulus(name, k))
        ins.append(_by_tile(name, stims[-1]))
    since = time.perf_counter()
    for io_chunk in (None, 8):
        outs = run_apps_batch(emus, ins, T, io_chunk=io_chunk)
        for name, stim, got in zip(APPS * 2, stims, outs):
            _check(name, stim, got)
    spans = obs.spans("emu.fused", since)
    assert spans and {(s.attrs["kernel"], s.attrs["cluster"])
                      for s in spans} == {(False, 0)}


def test_sweep_executor_records_emulate_the_reference(monkeypatch):
    """A design point's record routes every predicate app, and its
    emulation (the record's own counter stimulus) gives the reference's
    streams."""
    import repro_torch.fabric as fabric_pkg

    seen = {}
    batch, emulate = fabric_pkg.run_apps_batch, SweepExecutor._emulate_batch

    def keep_outs(emus, inputs, cycles, **kw):
        seen["outs"] = batch(emus, inputs, cycles, **kw)
        seen["inputs"] = inputs
        return seen["outs"]

    def keep_routed(self, ic, key, routed, **kw):
        seen["routed"] = routed
        return emulate(self, ic, key, routed, **kw)

    monkeypatch.setattr(fabric_pkg, "run_apps_batch", keep_outs)
    monkeypatch.setattr(SweepExecutor, "_emulate_batch", keep_routed)
    apps = {n: functools.partial(
        lambda n: app_graph(reference.load_app(n)), n) for n in APPS}
    ex = SweepExecutor(apps=apps, emulate_cycles=T, device="cpu",
                       use_kernels=True, store=False,
                       pipeline_emulation=False)
    rec = ex.run_point(make_spec({"spec": _small()}, alphas=(2.0,),
                                 sa_steps=30, sa_batch=8))
    for name in APPS:
        assert rec["apps"][name]["success"], rec["apps"][name]["error"]
        assert rec["apps"][name]["emulation"]["cycles"] == T
    names = [name for name, _, _ in seen["routed"]]
    assert names == APPS
    for (name, _, r), ins, got in zip(seen["routed"], seen["inputs"],
                                      seen["outs"]):
        app = reference.load_app(name)
        stim = {i: np.asarray(ins[tuple(r.placement[i])], np.int64)
                for i in reference.app_ios(app, "io_in")}
        for o, w in reference.evaluate(app, stim).items():
            np.testing.assert_array_equal(
                np.asarray(got[tuple(r.placement[o])], np.int64), w,
                err_msg=f"{name}.{o}")


def test_bitstream_round_trips_a_predicate_route():
    cf, r = _compiled(), _routed("window")
    words = cf.bitstream(r)
    codec = cf._codec
    assert words and np.array_equal(
        codec.decode(words), cf.fabric().route_to_config(r.route_edges()))


# ---------------------------------------------------------------- the ALU
EDGE = [0, 1, 0x7FFF, 0x8000, 0xFFFF]


@pytest.mark.parametrize("op", sorted(PRED_OP_IDS))
def test_each_predicate_op_matches_its_numpy_definition(op):
    a, b = (np.array(x, np.int64).ravel() for x in np.meshgrid(EDGE, EDGE))
    p0, p1 = a & 1, b & 1
    mod = reference.load_op(op)
    ports = {"data0": a, "data1": b, "bit0": p0, "bit1": p1}
    want = np.asarray(mod.apply(ports.__getitem__), np.int64) & (
        (1 << mod.WIDTH) - 1)
    t = [torch.as_tensor(x.astype(np.int32)) for x in (a, b, a, p0, p1)]
    cand = fabric_step.pe_alu_candidates(t[0], t[1], t[2],
                                         torch.zeros_like(t[0]),
                                         bits=(t[3], t[4]))
    got = cand[PRED_OP_IDS[op]].numpy().astype(np.int64) & (
        (1 << mod.WIDTH) - 1)
    np.testing.assert_array_equal(got, want)
    assert len(cand) == len(fabric_step.PE_OPS) + len(PRED_OP_IDS)


def test_base_alu_and_cluster_rule_are_unchanged():
    """The plain PE keeps its 14 ops, its 32 B record (48 B with the 1-bit
    inputs) and FULL its 8-block cluster; with the 1-bit inputs FULL fits
    a 16-block cluster even charging every block all 3P records, and the
    two-layer array only by its counted room."""
    a = torch.arange(-3, 3, dtype=torch.int32)
    assert len(fabric_step.pe_alu_candidates(a, a, a, a)) == 14

    def cluster(n, room, pred=False):
        return cluster_plan.plan(
            lambda c, r: fabric_step.fused_block_bytes(n, c, r, pred),
            room if isinstance(room, dict) else
            dict.fromkeys(cluster_plan.LADDER, room), lambda c, r: 1)[0]
    assert cluster(86_288, 2 * 780) == 8
    assert cluster(86_288, 3 * 780, pred=True) == 16
    assert cluster(179_312, 3 * 780, pred=True) == 0
    assert cluster(179_312, 208, pred=True) == 16
    assert (fabric_step.REC_BYTES, fabric_step.PRED_REC_BYTES) == (32, 48)


def test_fused_rooms_on_the_small_two_layer_fabric():
    """On the benchmark's small two-layer array (three outputs a PE) the
    room of each cluster size of 1-16 blocks is the most PE outputs that
    one block's slot range holds, counted on the host."""
    fab = _compiled().fabric()
    t = fab._fused_args()
    n, p = fab.arrays.num_nodes, fab.fused_tables["num_pe_slots"]
    assert t["pe_in"].shape == (p, fabric_step.PRED_PE_INPUTS)
    rooms = fabric_step.fused_rooms(t["src"], t["pe_res_idx"], 3 * p)
    slot = cluster_plan.order(t["src"])[1][:n].numpy()
    is_pe = t["pe_res_idx"].numpy() < 3 * p
    assert is_pe.sum() == 3 * p
    for c in cluster_plan.LADDER:
        chunk = -(-(n + 1) // c)
        per_block = [int(((slot // chunk == k) & is_pe).sum())
                     for k in range(c)]
        assert rooms[c] == max(per_block)
        assert sum(per_block) == 3 * p


def _pred_case(seed, b=4, n=400, f=5, p=20):
    """Random fused-engine tables in the predicate layout: pe_in (P, 7),
    three outputs a PE, ops over all 19."""
    rng = np.random.default_rng(seed)
    pe_nodes = rng.permutation(n)[:3 * p]
    pe_res_idx = np.full(n, 3 * p, np.int32)
    pe_res_idx[pe_nodes] = np.arange(3 * p, dtype=np.int32)
    return {
        "vals0": rng.integers(0, 1 << 16, (b, n)).astype(np.int32),
        "sel": rng.integers(0, f, (b, n)).astype(np.int32),
        "pin_vals": rng.integers(-5, 1 << 17, (b, n)).astype(np.int32),
        "depths": rng.integers(0, 7, b).astype(np.int32),
        "op": rng.integers(0, 19, (b, p)).astype(np.int32),
        "const": rng.integers(-5, 1 << 17, (b, p)).astype(np.int32),
        "imm_mask": (rng.random((b, p, 4)) < 0.3).astype(np.int32),
        "imm_val": rng.integers(-5, 1 << 17, (b, p, 4)).astype(np.int32),
        "src": rng.integers(0, n + 1, (n, f)).astype(np.int32),
        "keep": (rng.random(n) < 0.1).astype(np.int32),
        "pin_mask": (rng.random(n) < 0.15).astype(np.int32),
        "pe_in": rng.integers(0, n + 1, (p, 7)).astype(np.int32),
        "pe_res_idx": pe_res_idx,
        "pe_out": pe_nodes.reshape(p, 3).astype(np.int32),
    }


BATCH = ("vals0", "sel", "pin_vals", "depths", "op", "const", "imm_mask",
         "imm_val", "src", "keep", "pin_mask", "pe_in")


@pytest.mark.parametrize("seed,word", [(0, 0xFFFF), (1, -1), (2, 0xFFFF)])
def test_fused_plain_matches_the_scatter_oracle_with_bits(seed, word):
    case = _pred_case(seed)
    t = {k: torch.as_tensor(v) for k, v in case.items()}
    args = [t[k] for k in BATCH]
    got = fabric_step.fabric_fused_batch_plain(*args, t["pe_res_idx"],
                                               max_depth=6, word=word)
    want = ref.fabric_fused_batch_ref(*args, t["pe_out"], max_depth=6,
                                      word=word)
    assert torch.equal(got, want)


# ------------------------------------------------------------- refusals
def test_ready_valid_refuses_a_1_bit_layer():
    spec = InterconnectSpec(**dict(_small(), ready_valid=True,
                                   split_fifo=True, mem_columns=()))
    ic = canal_torch.compile(spec, device="cpu", analyze="off").interconnect
    with pytest.raises(ValueError, match="1-bit layer"):
        RVFabric(ic, device="cpu")
    plain = canal_torch.compile(spec.replace(extra_layers=()), device="cpu",
                                analyze="off").interconnect
    RVFabric(plain, device="cpu")


def test_predicate_ops_need_the_1_bit_layer():
    one = canal_torch.compile(make_spec({"spec": _small()},
                                        extra_layers=()), device="cpu")
    fab = one.fabric()
    with pytest.raises(ValueError, match="1-bit ports"):
        AppEmulator(fab, [], {fab.pe_coords[0]: ("psel", 0)})


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["cluster", "global"])
def test_fused_run_on_the_card_equals_the_eager_engine(cuda, variant,
                                                       monkeypatch):
    """The predicate apps on the small two-layer fabric through
    ``fabric_fused_run`` in the cluster variant and in the global-memory
    variant (the size rule patched to 0), bit-identical to the eager
    engine and to the reference; each launch's ``emu.fused`` span names
    the variant it ran."""
    if variant == "global":
        monkeypatch.setattr(fabric_step, "fused_plan",
                            lambda kernel, src, pe_res_idx, pe_in: (0, 0))
    cf = canal_torch.compile(make_spec({"spec": _small()}), device=cuda,
                             use_kernels=True)
    fab = cf.fabric()
    eager = cf.fabric(use_kernels=False)
    n = fab.arrays.num_nodes
    t = fab._fused_args()
    launched = fabric_step.fused_plan("fabric_fused_run", t["src"],
                                      t["pe_res_idx"], t["pe_in"])[0]
    assert (launched == 0) == (variant == "global")
    since = time.perf_counter()
    for name in APPS:
        r = cf.place_and_route(app_graph(reference.load_app(name)), **PNR)
        assert r.success, r.error
        stims = [_stimulus(name, k) for k in range(3)]
        emus = [AppEmulator.from_pnr(fab, r.packed, r)] * 3
        ins = [{tuple(r.placement[i]): v for i, v in s.items()}
               for s in stims]
        got = run_apps_batch(emus, ins, T, io_chunk=8)
        e = AppEmulator.from_pnr(eager, r.packed, r)
        for s, i, g in zip(stims, ins, got):
            want = e.run(i, T)
            assert all(np.array_equal(g[c], want[c]) for c in want)
            app = reference.load_app(name)
            for o, w in reference.evaluate(app, s).items():
                np.testing.assert_array_equal(
                    np.asarray(g[tuple(r.placement[o])], np.int64), w)
    spans = obs.spans("emu.fused", since)
    assert len(spans) >= len(APPS)
    assert {(s.attrs["kernel"], s.attrs["cluster"], s.attrs["nodes"])
            for s in spans} == {(True, launched, n)}


@pytest.mark.cuda
@pytest.mark.parametrize("n,cluster,b,t_len", [
    (5000, 1, 5, 4), (60000, 8, 5, 4), (120000, 16, 5, 4),
    (120000, 16, 40, 1), (250000, 0, 5, 4)])
def test_fused_kernels_with_bits_equal_their_plain_versions(cuda, n,
                                                            cluster, b,
                                                            t_len):
    """Random tables in the predicate layout (every op, immediates, cyclic
    configurations, lane depths of 0, 1, ``max_depth`` and past it), both
    fused kernels in the variant the size rule picks (16 blocks at N
    120,000 by the counted room; B 40 queues clusters the card cannot
    hold at once), bit-identical to their plain versions."""
    case = _pred_case(7, b=b, n=n, f=20, p=200)
    case["depths"] = np.resize(np.array([0, 1, 7, 10, 3], np.int32), b)
    t = {k: torch.as_tensor(v, device=cuda) for k, v in case.items()}
    for kernel in ("fabric_fused_batch", "fabric_fused_run"):
        plan = fabric_step.fused_plan(kernel, t["src"], t["pe_res_idx"],
                                      t["pe_in"])
        assert plan[0] == cluster
        if cluster and b >= 20:
            assert cluster_plan.active_clusters(kernel, n, cluster,
                                                plan[1], True) < b
    args = [t[k] for k in BATCH] + [t["pe_res_idx"]]
    want = fabric_step.fabric_fused_batch_plain(*args, max_depth=7,
                                                word=0xFFFF)
    got = fabric_step.fabric_fused_batch(*args, max_depth=7, word=0xFFFF)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    rng = np.random.default_rng(8)
    n_reg, n_io, n_mem = 12, 7, 3
    run = dict(
        ext=rng.integers(0, 1 << 16, (b, t_len, n_io)),
        pin_src=rng.integers(0, n_reg + n_io + n_mem + 1, n),
        reg_src=rng.integers(0, n + 1, n_reg),
        mem_in=rng.integers(0, n, n_mem), io_out=rng.integers(0, n, n_io))
    r = {k: torch.as_tensor(v.astype(np.int32), device=cuda)
         for k, v in run.items()}
    rargs = [t["sel"], r["ext"], t["depths"], t["op"], t["const"],
             t["imm_mask"], t["imm_val"], t["src"], t["keep"],
             t["pin_mask"], r["pin_src"], t["pe_in"], t["pe_res_idx"],
             r["reg_src"], r["mem_in"], r["io_out"]]
    kw = dict(n_reg=n_reg, n_io=n_io, n_mem=n_mem, max_depth=7, word=-1)
    want = fabric_step.fabric_fused_run_plain(*rargs, **kw)
    got = fabric_step.fabric_fused_run(*rargs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

"""The plain reference, the frozen roofline arithmetic and the trace
reader, each against hand-worked answers; the app netlists against the
program's ``BENCH_APPS`` they were copied from."""
import numpy as np
import pytest

from canalbench import reference, roofline, tracing

W = 0xFFFF


def _x(n=12, seed=0, lanes=()):
    return np.random.default_rng(seed).integers(0, 1 << 16, (*lanes, n))


def test_pointwise_adds_its_six_constants():
    x = _x()
    out = reference.evaluate(reference.load_app("pointwise"), {"in0": x})
    assert np.array_equal(out["out0"], (x + 21) & W)


def test_tree_reduce_sums_eight_inputs_in_16_bits():
    xs = {f"in{i}": _x(seed=i) for i in range(8)}
    out = reference.evaluate(reference.load_app("tree_reduce"), xs)
    assert np.array_equal(out["out0"], sum(xs.values()) & W)


def test_fir_delays_each_tap_by_its_registers():
    x = _x(lanes=(3,))
    out = reference.evaluate(reference.load_app("fir"), {"in0": x})["out0"]

    def d(v, k):
        return np.concatenate([np.zeros((3, k), v.dtype), v[:, :-k]], 1)

    assert np.array_equal(out, (x + 2 * d(x, 1) + 3 * d(x, 2)
                                + 4 * d(x, 3)) & W)


def test_stencil_reads_the_line_buffer_a_cycle_late():
    x = _x()
    out = reference.evaluate(reference.load_app("stencil"), {"in0": x})
    prev = np.concatenate([[0], x[:-1]])
    assert np.array_equal(out["out0"], (2 * x + prev) & W)


def test_butterfly_adds_and_subtracts_partners():
    xs = {f"in{i}": _x(seed=i) for i in range(4)}
    out = reference.evaluate(reference.load_app("butterfly"), xs)
    a = [xs[f"in{i}"] for i in range(4)]
    s0 = [(a[0] + a[1]) & W, (a[1] - a[0]) & W, (a[2] + a[3]) & W,
          (a[3] - a[2]) & W]
    s1 = [(s0[0] + s0[2]) & W, (s0[1] + s0[3]) & W, (s0[2] - s0[0]) & W,
          (s0[3] - s0[1]) & W]
    for i in range(4):
        assert np.array_equal(out[f"out{i}"], s1[i])


def test_wrong_streams_counts_each_differing_output():
    app = reference.load_app("butterfly")
    xs = {f"in{i}": _x(seed=i) for i in range(4)}
    got = dict(reference.evaluate(app, xs))
    assert reference.wrong_streams(app, xs, got) == 0
    got["out1"] = got["out1"].copy()
    got["out1"][5] ^= 1
    del got["out3"]
    assert reference.wrong_streams(app, xs, got) == 2


@pytest.mark.parametrize("name", ["pointwise", "tree_reduce", "fir",
                                  "stencil", "butterfly"])
def test_app_netlists_are_the_programs_bench_apps(name):
    from repro_torch.core.pnr.app import BENCH_APPS
    g = BENCH_APPS[name]()
    app = reference.load_app(name)
    assert app["instances"] == [[i.name, i.kind, i.op, i.const]
                                for i in g.instances.values()]
    assert app["nets"] == [[list(n.src), [list(s) for s in n.sinks]]
                           for n in g.nets]


def test_placement_rules():
    app = reference.load_app("stencil")
    geo = {"width": 8, "height": 8, "mem_columns": [2], "io_ring": True}
    good = {"in0": (0, 3), "out0": (7, 3), "lb": (2, 3), "m0": (3, 3),
            "s0": (4, 4)}
    assert reference.placement_faults(app, good, geo) == 0
    assert reference.placement_faults(app, dict(good, s0=(3, 3)), geo) == 1
    assert reference.placement_faults(app, dict(good, lb=(3, 4)), geo) == 1
    assert reference.placement_faults(app, dict(good, m0=(2, 5)), geo) == 1
    assert reference.placement_faults(app, dict(good, in0=(3, 3)), geo) == 1
    del good["out0"]
    assert reference.placement_faults(app, good, geo) == 1


def test_token_faults():
    sent = np.arange(1, 11)
    assert reference.token_faults(sent, sent) == {
        "tokens_missing": 0, "tokens_extra": 0, "tokens_wrong": 0}
    assert reference.token_faults(sent, sent[:7]) == {
        "tokens_missing": 3, "tokens_extra": 0, "tokens_wrong": 0}
    swapped = sent.copy()
    swapped[[2, 3]] = swapped[[3, 2]]
    assert reference.token_faults(sent, np.append(swapped, 5))[
        "tokens_wrong"] == 2


def test_roofline_counts_the_problem_not_the_kernel():
    e = roofline.emulation_batch(connections=1000, num_config=300,
                                 num_pe=10, num_io=4, depths=[3, 5],
                                 cycles=7)
    assert e["ops"] == (3 + 5) * 7 * 1000
    assert e["bytes"] == 4 * (1000 + 2 * (300 + 100) + 2 * 2 * 7 * 4)
    r = roofline.rv_cycles(connections=1000, num_config=300,
                           fifo_stages=20, num_io=4, depth=9, cycles=5)
    assert r["ops"] == 5 * 9 * 1000 * 3 + 5 * 20
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)


def test_trace_summary_busy_gaps_and_unit_device_time():
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [ev("user_annotation", tracing.SAMPLE_SPAN, 0, 100),
              ev("user_annotation", "trace.rv", 10, 40),
              ev("user_annotation", "trace.rv", 60, 30),
              ev("kernel", "k1", 12, 10), ev("kernel", "k2", 18, 10),
              ev("kernel", "k1", 65, 5), ev("kernel", "outside", 150, 9)]
    units = [{"name": "trace.rv", "work": {}}, {"name": "trace.rv",
                                                "work": {}}]
    s = tracing.summarize(events, units)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(21e-6)
    assert units[0]["device_s"] == pytest.approx(20e-6)
    assert units[1]["device_s"] == pytest.approx(5e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(15e-6)]
    gaps = dict((round(sec * 1e6), name) for name, sec in s["idle_gaps"])
    # 0-12 before the first unit, 28-65 and 70-100 inside the units
    assert gaps == {12: tracing.SAMPLE_SPAN, 37: "trace.rv", 30: "trace.rv"}


@pytest.mark.parametrize("kw", [
    dict(num_tracks=5, sb_type="wilton"), dict(num_tracks=4, sb_type="imran"),
    dict(num_tracks=6, sb_type="disjoint"),
    dict(num_tracks=3, sb_sides=2, cb_sides=3),
    dict(num_tracks=5, ready_valid=True, split_fifo=True),
    dict(num_tracks=4, ready_valid=True, split_fifo=False)],
    ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_area_model_agrees_with_the_programs_compiled_area(kw):
    """The spec-only area model equals the program's IR-driven one
    (``CompiledFabric.area``) where the program applies it."""
    import canal_torch
    from repro_torch.core.spec import spec_from_kwargs
    fields = dict(width=10, height=10, track_width=16, reg_density=1.0,
                  io_ring=True, mem_columns=[2], **kw)
    spec = spec_from_kwargs(**dict(fields, mem_columns=(2,)))
    got = canal_torch.compile(spec, device="cpu").area()
    assert not reference.area_mismatch(fields, got)
    assert reference.area_mismatch(fields, dict(got, cb_area=got[
        "cb_area"] * (1 + 1e-6)))


def test_split_fifos_add_a_third_to_the_switch_box():
    base = dict(width=32, height=32, num_tracks=5, mem_columns=[4, 12])
    static = reference.tile_area(base)["sb_area"]
    split = reference.tile_area(dict(base, ready_valid=True,
                                     split_fifo=True))["sb_area"]
    full = reference.tile_area(dict(base, ready_valid=True))["sb_area"]
    assert 0.25 < split / static - 1 < 0.4 < full / static - 1 < 0.6

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Canal on one NVIDIA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card and nvcc.
Phases (any failure raises, so the script exits non-zero):

1. build   — nvcc builds ``src/repro_torch/kernels/csrc/*.cu`` into
             ``build/kernels/`` (one process per source, in parallel).
2. main    — the main path at the full size of the paper's artifact,
             ``cgra_amber.FULL`` (32x32, 5 tracks, 86,288 IR nodes):
             ``canal_torch.compile(FULL, use_kernels=True)`` on the card,
             place-and-route of the five bench apps (``auto`` strategies,
             which resolve to the minplus router and the batched
             annealer), bitstreams, and ``run_apps_batch`` over all five
             apps unstreamed and with ``io_chunk=8``. Launch counts are
             zeroed just before and read just after; every kernel must
             have launched. Outputs are checked against the port's
             scatter-based oracle (``use_kernels=False``), the two
             emulation modes against each other, and the pointwise app
             against its dataflow semantics (out = in + 1 + ... + 6).
3. kernels — every kernel against its plain PyTorch version on the card,
             at the main path's shapes (bit-identical, min-plus
             included), with CUDA-event times of the kernel and the plain
             version and the least time the card could take (``bound``).

Before the last line it prints the per-app PnR seconds, the emulation
times, the ``kernels`` JSON line and the card's name and power limit; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout, it exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

T = 16                       # emulated cycles (the DSE executor's default)
IO_CHUNK = 8
#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and the
#: CUDA-core rate (float32 outside the tensor cores), used for the
#: integer and float compare/add work of these kernels
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, reps=5):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_ops):
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the CUDA-core rate."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------ main path
def counter_stimulus(result):
    """The DSE executor's stimulus: a counter 1..T on every app input."""
    return {result.placement[name]: np.arange(1, T + 1, dtype=np.int32)
            for name, inst in result.packed.placeable.items()
            if inst.kind == "io_in"}


def main_path(spec, device):
    """compile -> PnR -> bitstream -> batched emulation; returns the
    compiled fabric, the routed apps and a report."""
    import canal_torch
    from repro_torch.core.pnr.app import BENCH_APPS
    from repro_torch.fabric import AppEmulator, run_apps_batch

    report = {}
    t0 = time.perf_counter()
    fab = canal_torch.compile(spec, device=device, use_kernels=True)
    fabric = fab.fabric()
    report["compile_s"] = time.perf_counter() - t0
    report["nodes"] = fabric.arrays.num_nodes
    log(f"compiled {fab!r}: {fabric.arrays.num_nodes} nodes, "
        f"{fabric.num_config} config slots, {fabric.num_pe} PEs, "
        f"{fabric.num_io} IOs, {fabric.num_mem} MEMs in "
        f"{report['compile_s']:.1f} s")

    routed, pnr_s, words = {}, {}, {}
    for name, make in BENCH_APPS.items():
        r = fab.place_and_route(make())
        if not r.success:
            raise RuntimeError(f"{name}: PnR failed: {r.error}")
        routed[name] = r
        pnr_s[name] = r.seconds
        words[name] = len(fab.bitstream(r))
        log(f"{name}: routed by {r.route_strategy}, placed by "
            f"{r.place_strategy}, {r.seconds:.2f} s, "
            f"{r.timing['critical_path_ns']:.3f} ns, {words[name]} words")
    report["pnr_s"] = pnr_s
    report["bitstream_words"] = words
    report["strategies"] = {n: (r.route_strategy, r.place_strategy)
                            for n, r in routed.items()}

    emus = [AppEmulator.from_pnr(fabric, r.packed, r)
            for r in routed.values()]
    ins = [counter_stimulus(r) for r in routed.values()]
    report["depths"] = [e.depth for e in emus]
    emu_ms = {}
    outs = {}
    for mode, chunk in (("unstreamed", None), ("io_chunk", IO_CHUNK)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[mode] = run_apps_batch(emus, ins, T, io_chunk=chunk)
        torch.cuda.synchronize()
        emu_ms[mode] = (time.perf_counter() - t0) * 1e3
    report["emulation_ms"] = emu_ms
    return fab, routed, emus, ins, outs, report


def check_main_path(fab, routed, emus, ins, outs, report):
    """What came out is right: streamed == unstreamed == the scatter
    oracle, and the pointwise app computes in + 1 + ... + 6."""
    from repro_torch.core.pnr.app import BENCH_APPS
    from repro_torch.fabric import AppEmulator, run_apps_batch

    for name, (route, place) in report["strategies"].items():
        if (route, place) != ("minplus", "batched"):
            raise AssertionError(f"{name}: auto resolved to {route}/{place}")
    for a, b in zip(outs["unstreamed"], outs["io_chunk"]):
        for coord in a:
            if not np.array_equal(a[coord], b[coord]):
                raise AssertionError("io_chunk emulation diverged")
    oracle_fab = fab.fabric(use_kernels=False)
    oracle_emus = [AppEmulator.from_pnr(oracle_fab, r.packed, r)
                   for r in routed.values()]
    oracle = run_apps_batch(oracle_emus, ins, T)
    for got, want in zip(outs["unstreamed"], oracle):
        for coord in want:
            if not np.array_equal(got[coord], want[coord]):
                raise AssertionError("kernel emulation != scatter oracle")
    r = routed["pointwise"]
    app_consts = sum(inst.const
                     for inst in BENCH_APPS["pointwise"]().instances.values()
                     if inst.kind == "const")
    x = np.arange(1, T + 1, dtype=np.int32)
    y = outs["unstreamed"][list(routed).index("pointwise")][
        r.placement["out0"]]
    nz = np.nonzero(y)[0]
    if not len(nz):
        raise AssertionError("pointwise: no output observed")
    lat = int(nz[0])
    if not np.array_equal(y[lat:], x[:T - lat] + app_consts):
        raise AssertionError(f"pointwise: {y} != in + {app_consts}")
    return {"pointwise_latency": lat, "pointwise_offset": int(app_consts)}


# ------------------------------------------------------------ kernel checks
def random_workload(fabric, batch, seed):
    """``dse._random_fabric_workload``'s draws on the given fabric: random
    selects (so cyclic configurations with per-lane depths occur),
    random stimulus, per-config combinational depths."""
    rng = np.random.default_rng(seed)
    cfgs = rng.integers(0, 4, (batch, fabric.num_config)).astype(np.int32)
    ext = rng.integers(0, 256, (batch, T, fabric.num_io)).astype(np.int32)
    depths = np.array([fabric.combinational_depth(c) for c in cfgs],
                      np.int32)
    return cfgs, ext, depths


def fabric_kernel_rows(fabric, device, batch):
    from repro_torch.core.lowering import WORD
    from repro_torch.kernels import fabric_step as fs

    cfgs, ext, depths_np = random_workload(fabric, batch, seed=0)
    max_depth = int(depths_np.max())
    sel = fabric._selects(torch.as_tensor(cfgs, device=device))
    rng = np.random.default_rng(1)
    p = fabric.fused_tables["num_pe_slots"]
    pe_cfg = {"op": rng.integers(0, len(fs.PE_OPS), (batch, p)),
              "const": rng.integers(0, 1 << 16, (batch, p)),
              "imm_mask": rng.random((batch, p, 4)) < 0.2,
              "imm_val": rng.integers(0, 1 << 16, (batch, p, 4))}
    op, const, imm_mask, imm_val = fabric._norm_pe_cfg(pe_cfg, batch)
    t = fabric._fused_args()
    s = fabric.stream_tables()
    depths = torch.as_tensor(depths_np, device=device)
    state = fabric.init_state_batch(batch)
    ext_t = torch.as_tensor(ext, device=device)
    pin_vals = fabric._pin(torch.zeros_like(sel), state, ext_t[:, 0])
    batch_args = (pin_vals, sel, pin_vals, depths, op, const, imm_mask,
                  imm_val, t["src"], t["keep"], t["pin_mask"], t["pe_in"],
                  t["pe_res_idx"])

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    run_args = (sel, ext_t, depths, op, const, imm_mask, imm_val, t["src"],
                t["keep"], t["pin_mask"], i32(s["pin_src"]), t["pe_in"],
                t["pe_res_idx"], i32(s["reg_src"]), i32(s["mem_in"]),
                i32(s["io_out"]))
    run_kw = dict(n_reg=s["n_reg"], n_io=fabric.num_io,
                  n_mem=fabric.num_mem, max_depth=max_depth, word=WORD)

    rows = []
    got = fs.fabric_fused_batch(*batch_args, max_depth=max_depth, word=WORD)
    want = fs.fabric_fused_batch_plain(*batch_args, max_depth=max_depth,
                                       word=WORD)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"fabric_fused_batch differs (max {err})")
    sweeps = int(np.minimum(depths_np, max_depth).sum())
    b_ms, b_by = bound(nbytes(*batch_args[1:]) + nbytes(got),
                       sweeps * fabric.arrays.num_nodes)
    rows.append({
        "name": "fabric_fused_batch", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fabric_step.cu",
        "replaces": "src/repro/kernels/fabric_step.py:324",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: fs.fabric_fused_batch(
            *batch_args, max_depth=max_depth, word=WORD)),
        "plain_ms": cuda_ms(lambda: fs.fabric_fused_batch_plain(
            *batch_args, max_depth=max_depth, word=WORD), reps=2),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"B": batch, "N": fabric.arrays.num_nodes,
                  "F": fabric.arrays.max_fanin, "P": p,
                  "max_depth": max_depth, "depths": depths_np.tolist()}})

    got = fs.fabric_fused_run(*run_args, chunk=IO_CHUNK, **run_kw)
    want = fs.fabric_fused_run_plain(*run_args, chunk=IO_CHUNK, **run_kw)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"fabric_fused_run differs (max {err})")
    b_ms, b_by = bound(nbytes(*run_args) + nbytes(got),
                       T * sweeps * fabric.arrays.num_nodes)
    rows.append({
        "name": "fabric_fused_run", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fabric_step.cu",
        "replaces": "src/repro/kernels/fabric_step.py:519",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: fs.fabric_fused_run(*run_args, chunk=IO_CHUNK,
                                                  **run_kw)),
        "plain_ms": cuda_ms(lambda: fs.fabric_fused_run_plain(
            *run_args, chunk=IO_CHUNK, **run_kw), reps=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"B": batch, "T": T, "N": fabric.arrays.num_nodes,
                  "n_io": fabric.num_io, "R": s["n_reg"],
                  "M": fabric.num_mem, "max_depth": max_depth}})
    return rows


def minplus_row(fab, device):
    """Exact agreement at N = tiles of the fabric for B in {1, 8, 32}, on
    the router's own coarse weights; times at B = 32."""
    from repro_torch.kernels import minplus as mp

    res = fab.resources()
    coarse = res.coarse()
    w_np = coarse.lower_bound_weights(res.base).T.astype(np.float32)
    w = torch.as_tensor(np.ascontiguousarray(w_np), device=device)
    n = w.shape[0]
    rng = np.random.default_rng(2)
    err = 0.0
    for b in (1, 8, 32):
        d0 = np.full((b, n), mp.INF, np.float32)
        live = max(1, (3 * b) // 4)             # the rest: padding lanes
        d0[np.arange(live), rng.choice(n, live, replace=False)] = 0.0
        d0 = torch.as_tensor(d0, device=device)
        got = mp.minplus_wavefront(d0, w)
        want = d0
        for _ in range(max(1, -(-max(n - 1, 1) // 8))):
            nd = want
            for _ in range(8):
                nd = mp.minplus_step_plain(nd, w)
            if torch.equal(nd, want):
                break
            want = nd
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"minplus_wavefront differs at B={b}")
        if not torch.equal(mp.minplus_step(d0, w),
                           mp.minplus_step_plain(d0, w)):
            raise AssertionError(f"minplus_step differs at B={b}")
        err = max(err, float((got - want).abs().max()))
    b_ms, b_by = bound(nbytes(d0, w, d0), 2 * d0.shape[0] * n * n)
    return {"name": "minplus_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/minplus.cu",
            "replaces": "src/repro/kernels/minplus.py:80",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: mp.minplus_step(d0, w), reps=20),
            "plain_ms": cuda_ms(lambda: mp.minplus_step_plain(d0, w),
                                reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"B": int(d0.shape[0]), "N": n}}


def bbox_row(routed, device):
    """Random nets with empty ones, at the (n_nets, K) of the largest
    bench app's pin table."""
    from repro_torch.core.pnr.batched_anneal import _net_members
    from repro_torch.kernels import hpwl

    shapes = []
    for r in routed.values():
        idx = {name: i for i, name in enumerate(r.packed.placeable)}
        members = _net_members(r.packed, idx)
        shapes.append((len(members), max(len(m) for m in members)))
    n, k = max(shapes)
    rng = np.random.default_rng(3)
    pins = rng.integers(0, 32, (n, k, 2)).astype(np.int32)
    mask = (rng.random((n, k)) < 0.7).astype(np.int32)
    mask[:: 5] = 0                                   # empty nets
    p_t = torch.as_tensor(pins, device=device)
    m_t = torch.as_tensor(mask, device=device)
    got = hpwl.net_bboxes(p_t, m_t)
    want = hpwl.net_bboxes_plain(p_t, m_t)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("net_bboxes differs")
    b_ms, b_by = bound(nbytes(p_t, m_t, got), 4 * n * k)
    return {"name": "net_bboxes", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hpwl.cu",
            "replaces": "src/repro/kernels/hpwl.py:111",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: hpwl.net_bboxes(p_t, m_t), reps=20),
            "plain_ms": cuda_ms(lambda: hpwl.net_bboxes_plain(p_t, m_t),
                                reps=20),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"n_nets": n, "K": k}}


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs.cgra_amber import FULL
    from repro_torch.kernels import build

    device = torch.device("cuda")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    t0 = time.perf_counter()
    build.library()
    log(f"kernel library built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds:.1f} s)")

    # 2. main path, with launch counts zeroed just before and read after
    build.reset_launch_counts()
    fab, routed, emus, ins, outs, report = main_path(FULL, device)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log(f"main path launches: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    report.update(check_main_path(fab, routed, emus, ins, outs, report))

    # 3. every kernel against its plain version at the main path's shapes
    rows = fabric_kernel_rows(fab.fabric(), device, batch=len(routed))
    rows.append(minplus_row(fab, device))
    rows.append(bbox_row(routed, device))
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    rows = [{k: row[k] for k in keys} for row in rows]

    print(json.dumps({"pnr_seconds": report["pnr_s"],
                      "compile_seconds": report["compile_s"],
                      "nodes": report["nodes"],
                      "bitstream_words": report["bitstream_words"],
                      "depths": report["depths"],
                      "pointwise_latency": report["pointwise_latency"]}))
    print(json.dumps({"emulation_ms": report["emulation_ms"],
                      "apps": len(routed), "cycles": T,
                      "io_chunk": IO_CHUNK}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"seconds": time.perf_counter() - t_start}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

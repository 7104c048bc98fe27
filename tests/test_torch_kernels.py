"""The port's nine kernels against the JAX reference.

On the CPU every wrapper runs its plain PyTorch version, which must be
bit-identical to the reference's Pallas kernel run in interpret mode
(min-plus included: every candidate is one rounded add and ``min`` is
exact). The two float kernels of the LM substrate (flash attention, the
SSD scan) agree within the reference tests' own tolerances instead, and
also with the float64 oracles. Inputs are made with numpy from a seed
and handed to both.

``TestCudaKernels`` (marked ``cuda``) holds each CUDA kernel against its
plain version on the card; it skips on a host without CUDA. The JAX side
is imported inside a fixture, so that class also runs where JAX is
absent: ``python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""
import functools
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import (build, cluster_plan, fabric_step,
                                 flash_attention, hpwl, minplus, ref,
                                 rv_sweep, ssd_scan)

INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
#: operand pool: int32 extremes, shifts around the [0, 15] clip, negatives
EDGE = np.array([INT_MIN, INT_MAX, INT_MIN + 1, -1, 0, 1, 2, 7, 15, 16, 17,
                 31, 32, -5, -16, 0x7FFF, 0x8000, 0xFFFF, 0x10000, 12345,
                 -98765, 1 << 30], np.int64)


@pytest.fixture(scope="module")
def jref():
    """The reference kernels (JAX, interpret mode on this host)."""
    pytest.importorskip("jax")
    from repro.kernels import fabric_step as jfs
    from repro.kernels import hpwl as jhp
    from repro.kernels import minplus as jmp
    from repro.kernels import ref as jr
    return jfs, jhp, jmp, jr


def _edge_ints(rng, shape):
    """int32 values: half from the edge pool, half random full-range."""
    pick = EDGE[rng.integers(0, len(EDGE), shape)]
    rand = rng.integers(INT_MIN, INT_MAX, shape, endpoint=True)
    return np.where(rng.random(shape) < 0.5, pick, rand).astype(np.int32)


def fabric_case(seed, b=5, n=300, f=6, p=16, t_len=5):
    """Random fused-engine tables: random fan-in (so configurations are
    cyclic), per-lane depths, PE outputs scattered over the nodes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n + 1, (n, f)).astype(np.int32)
    pe_nodes = rng.permutation(n)[:2 * p]
    pe_res_idx = np.full(n, 2 * p, np.int32)
    pe_res_idx[pe_nodes] = np.arange(2 * p, dtype=np.int32)
    pe_out = pe_nodes.reshape(p, 2).astype(np.int32)
    n_reg, n_io, n_mem = 12, 7, 3
    return {
        "vals0": rng.integers(0, 1 << 16, (b, n)).astype(np.int32),
        "sel": rng.integers(0, f, (b, n)).astype(np.int32),
        "pin_vals": _edge_ints(rng, (b, n)),
        "depths": rng.integers(0, 7, b).astype(np.int32),
        "op": rng.integers(0, len(fabric_step.PE_OPS), (b, p)).astype(
            np.int32),
        "const": _edge_ints(rng, (b, p)),
        "imm_mask": (rng.random((b, p, 4)) < 0.3).astype(np.int32),
        "imm_val": _edge_ints(rng, (b, p, 4)),
        "src": src,
        "keep": (rng.random(n) < 0.1).astype(np.int32),
        "pin_mask": (rng.random(n) < 0.15).astype(np.int32),
        "pe_in": rng.integers(0, n + 1, (p, 4)).astype(np.int32),
        "pe_res_idx": pe_res_idx,
        "pe_out": pe_out,
        "ext": _edge_ints(rng, (b, t_len, n_io)),
        "pin_src": rng.integers(0, n_reg + n_io + n_mem + 1, n).astype(
            np.int32),
        "reg_src": rng.integers(0, n + 1, n_reg).astype(np.int32),
        "mem_in": rng.integers(0, n, n_mem).astype(np.int32),
        "io_out": rng.integers(0, n, n_io).astype(np.int32),
        "n_reg": n_reg, "n_io": n_io, "n_mem": n_mem,
    }


BATCH_ARGS = ("vals0", "sel", "pin_vals", "depths", "op", "const",
              "imm_mask", "imm_val", "src", "keep", "pin_mask", "pe_in",
              "pe_res_idx")
RUN_ARGS = ("sel", "ext", "depths", "op", "const", "imm_mask", "imm_val",
            "src", "keep", "pin_mask", "pin_src", "pe_in", "pe_res_idx",
            "reg_src", "mem_in", "io_out")
RUN_KW = ("n_reg", "n_io", "n_mem")


def _t(case, names, device="cpu"):
    return [torch.as_tensor(case[k], device=device) for k in names]


def test_pe_alu_candidates_int32_semantics(jref):
    """Wrap in add/sub/mul/shl, shifts >= 16 clipped, negative >>, abs at
    INT_MIN: the whole ALU stack equals the reference's bit for bit."""
    jfs = jref[0]
    import jax.numpy as jnp
    grid = np.array(np.meshgrid(EDGE, EDGE)).reshape(2, -1).astype(np.int32)
    a, b = grid
    c = np.roll(a, 3)
    const = np.roll(b, 5)
    want = np.asarray(jfs.pe_alu_candidates(*map(jnp.asarray, (a, b, c,
                                                                const))))
    got = fabric_step.pe_alu_candidates(*map(torch.as_tensor,
                                             (a, b, c, const))).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,b,word,max_depth", [
    (0, 5, 0xFFFF, 6), (1, 1, 0xFFFF, 3), (2, 9, -1, 6), (3, 3, -1, 8)])
def test_fused_batch_plain_matches_pallas(jref, seed, b, word, max_depth):
    jfs, _, _, jr = jref
    import jax.numpy as jnp
    case = fabric_case(seed, b=b)
    want = np.asarray(jfs.fabric_fused_batch(
        *[jnp.asarray(case[k]) for k in BATCH_ARGS], max_depth=max_depth,
        word=word, interpret=True))
    got = fabric_step.fabric_fused_batch(*_t(case, BATCH_ARGS),
                                         max_depth=max_depth, word=word)
    np.testing.assert_array_equal(got.numpy(), want)
    # the scatter-based oracles of both packages agree as well
    ref_args = [k if k != "pe_res_idx" else "pe_out" for k in BATCH_ARGS]
    want_ref = np.asarray(jr.fabric_fused_batch_ref(
        *[jnp.asarray(case[k]) for k in ref_args], max_depth=max_depth,
        word=word))
    got_ref = ref.fabric_fused_batch_ref(*_t(case, ref_args),
                                         max_depth=max_depth, word=word)
    np.testing.assert_array_equal(got_ref.numpy(), want_ref)


@pytest.mark.parametrize("seed,b,t_len,chunk,word", [
    (4, 5, 5, 2, 0xFFFF), (5, 2, 7, 8, -1), (6, 9, 3, 1, 0xFFFF)])
def test_fused_run_plain_matches_pallas(jref, seed, b, t_len, chunk, word):
    jfs = jref[0]
    import jax.numpy as jnp
    case = fabric_case(seed, b=b, t_len=t_len)
    kw = {k: case[k] for k in RUN_KW}
    want = np.asarray(jfs.fabric_fused_run(
        *[jnp.asarray(case[k]) for k in RUN_ARGS], **kw, max_depth=6,
        chunk=chunk, word=word, interpret=True))
    got = fabric_step.fabric_fused_run(*_t(case, RUN_ARGS), **kw,
                                       max_depth=6, chunk=chunk, word=word)
    np.testing.assert_array_equal(got.numpy(), want)


def minplus_case(seed, b=6, n=70):
    """Sparse random weights with INF gaps, zero diagonal, and lanes that
    are all INF (the router's power-of-two padding lanes)."""
    rng = np.random.default_rng(seed)
    inf = np.float32(minplus.INF)
    w = np.where(rng.random((n, n)) < 0.08,
                 rng.uniform(0.01, 3.0, (n, n)), inf).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    d = np.full((b, n), inf, np.float32)
    seeds = rng.integers(0, n, b)
    live = (b + 1) // 2
    d[np.arange(live), seeds[:live]] = 0.0              # rest stay all-INF
    return d, w


@pytest.mark.parametrize("seed,b,n", [(0, 6, 70), (1, 1, 130), (2, 8, 20)])
def test_minplus_step_exact(jref, seed, b, n):
    jmp = jref[2]
    import jax.numpy as jnp
    d, w = minplus_case(seed, b, n)
    for _ in range(3):                        # relax a few steps deep
        want = np.asarray(jmp.minplus_step(jnp.asarray(d), jnp.asarray(w),
                                           interpret=True))
        got = minplus.minplus_step(torch.as_tensor(d),
                                   torch.as_tensor(w)).numpy()
        np.testing.assert_array_equal(got, want)
        d = np.array(want)


@pytest.mark.parametrize("seed,b,n", [(3, 4, 40), (4, 8, 57)])
def test_minplus_wavefront_exact(jref, seed, b, n):
    """Same stop/cap contract: the converged fields are equal bit for bit
    to the reference's blocked Pallas wavefront."""
    jmp = jref[2]
    d, w = minplus_case(seed, b, n)
    want = np.asarray(jmp.minplus_wavefront(d, w, engine="pallas",
                                            interpret=True))
    got = minplus.minplus_wavefront(torch.as_tensor(d),
                                    torch.as_tensor(w)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[(b + 1) // 2:] == np.float32(minplus.INF)).all()


def bbox_case(seed, n=300, k=9):
    """Pins with empty nets, single-pin nets and masked-out pins whose
    coordinates would win the min/max if they were read."""
    rng = np.random.default_rng(seed)
    pins = rng.integers(-50, 400, (n, k, 2)).astype(np.int32)
    mask = (rng.random((n, k)) < 0.6).astype(np.int32)
    mask[rng.random(n) < 0.1] = 0                       # empty nets
    pins[mask == 0] = rng.choice([-(1 << 21), 1 << 21, 0],
                                 ((mask == 0).sum(), 2))
    return pins, mask


@pytest.mark.parametrize("seed,n,k", [(0, 300, 9), (1, 1, 1), (2, 513, 40)])
def test_net_bboxes_plain_matches_pallas(jref, seed, n, k):
    jhp = jref[1]
    import jax.numpy as jnp
    pins, mask = bbox_case(seed, n, k)
    want = np.asarray(jhp.net_bboxes(jnp.asarray(pins), jnp.asarray(mask),
                                     interpret=True))
    got = hpwl.net_bboxes(torch.as_tensor(pins), torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def wide_box_case(seed, n, k):
    """``bbox_case`` with a tenth of the live pins beyond +/- SENTINEL, so
    that a live pin must win over the sentinel a masked pin reads."""
    pins, mask = bbox_case(seed, n, k)
    rng = np.random.default_rng(seed + 1)
    far = (mask > 0) & (rng.random((n, k)) < 0.1)
    pins[far] = rng.choice([-(1 << 22), (1 << 20) + 1, -(1 << 20) - 1,
                            1 << 23], (int(far.sum()), 2))
    return pins, mask


def design_box_case(seed=0, n=1 << 20, k=4):
    """The reference docstring's batched shape: 64 chains x 4 candidates x
    4,096 nets at K 4, random pins, ~30% of them masked, every fifth net
    empty."""
    rng = np.random.default_rng(seed)
    pins = rng.integers(0, 32, (n, k, 2)).astype(np.int32)
    mask = (rng.random((n, k)) < 0.7).astype(np.int32)
    mask[::5] = 0
    return pins, mask


def test_box_group_is_the_next_power_of_two_up_to_a_warp():
    """G for K 1..70: the least power of two at least K, 32 past a warp."""
    for k in range(1, 71):
        g = hpwl.box_group(k)
        assert g in (1, 2, 4, 8, 16, 32)
        assert g >= min(k, 32) and (g == 1 or g // 2 < min(k, 32)), k


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 17, 33, 64])
@pytest.mark.parametrize("n", [0, 1, 15, 1 << 20])
def test_box_tiles_cover_every_net_once_in_one_wave(n, k):
    """``net_bboxes``/``hpwl``'s size rule: blocks of whole warps, groups
    of G lanes that divide them, one block while n is small, never more
    than one wave; the kernel's walk (each warp's groups take nets w +
    j W, four at a time, while the warp's first group has nets left)
    covers every net exactly once, every pin of a net by one of its
    lanes."""
    g, blocks, threads = hpwl.box_tiles(n, k)
    sms, per_sm = fabric_step.SM_COUNT, fabric_step.SM_THREADS
    assert g == hpwl.box_group(k)
    assert threads == hpwl.BOX_THREADS and threads % 32 == 0
    assert blocks >= 1 and blocks * threads <= sms * per_sm
    if max(n, 1) * g <= hpwl.BOX_THREADS:
        assert blocks == 1
    if n == 1 << 20:
        assert blocks * threads == sms * per_sm        # one full wave
    assert all(len(range(lane, k, g)) >= 1 for lane in range(min(k, g)))
    groups = blocks * threads // g
    group = np.arange(groups)
    warp_first = group - group % (32 // g)
    seen = np.zeros(n, np.int64)
    base = 0
    while (warp_first + base < n).any():
        for u in range(4):
            net = group + base + u * groups
            np.add.at(seen, net[(warp_first + base < n) & (net < n)], 1)
        base += 4 * groups
    assert (seen == 1).all()


def sweep_case(seed, b=5, n=300, f=6):
    """Random sweep tables: every src entry in [0, N] (N is the zero
    sentinel of absent fan-in, so some nodes read it), selects in
    [0, F)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n + 1, (n, f)).astype(np.int32)
    src[rng.random((n, f)) < 0.2] = n                   # sentinel entries
    vals = _edge_ints(rng, (b, n + 1))
    vals[:, n] = 0
    sel = rng.integers(0, f, (b, n)).astype(np.int32)
    return vals, src, sel


@pytest.mark.parametrize("seed,n,f", [(0, 300, 6), (1, 1, 1), (2, 700, 20)])
def test_fabric_sweep_plain_matches_pallas(jref, seed, n, f):
    jfs = jref[0]
    import jax.numpy as jnp
    vals, src, sel = sweep_case(seed, 1, n, f)
    want = np.asarray(jfs.fabric_sweep(jnp.asarray(vals[0]),
                                       jnp.asarray(src),
                                       jnp.asarray(sel[0]), interpret=True))
    got = fabric_step.fabric_sweep(torch.as_tensor(vals[0]),
                                   torch.as_tensor(src),
                                   torch.as_tensor(sel[0]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,b,n,f", [(3, 5, 300, 6), (4, 1, 1, 1),
                                        (5, 9, 513, 20), (6, 16, 64, 3)])
def test_fabric_sweep_batch_plain_matches_pallas(jref, seed, b, n, f):
    """B not a multiple of the reference's 8-config blocks, N not a
    multiple of its 512-node blocks, the sentinel read as zero."""
    jfs, _, _, jr = jref
    import jax.numpy as jnp
    vals, src, sel = sweep_case(seed, b, n, f)
    args = tuple(map(jnp.asarray, (vals, src, sel)))
    want = np.asarray(jfs.fabric_sweep_batch(*args, interpret=True))
    np.testing.assert_array_equal(want,
                                  np.asarray(jr.fabric_sweep_batch_ref(*args)))
    got = fabric_step.fabric_sweep_batch(*map(torch.as_tensor,
                                              (vals, src, sel)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[np.broadcast_to(src, (b, n, f))[
        np.arange(b)[:, None], np.arange(n)[None], sel] == n] == 0).all()


@pytest.mark.parametrize("seed,n,k,wide", [(0, 300, 9, False),
                                           (1, 1, 1, False),
                                           (2, 513, 40, False),
                                           (3, 64, 5, True)])
def test_hpwl_plain_matches_pallas(jref, seed, n, k, wide):
    """Empty nets read 0, K = 1, masked-out pins beyond the sentinel are
    never read; ``wide`` coordinates overflow int32 and wrap as in the
    reference."""
    jhp, jr = jref[1], jref[3]
    import jax.numpy as jnp
    pins, mask = bbox_case(seed, n, k)
    if wide:
        rng = np.random.default_rng(seed)
        pins = _edge_ints(rng, pins.shape)
    want = np.asarray(jhp.hpwl(jnp.asarray(pins), jnp.asarray(mask),
                               interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jr.hpwl_ref(jnp.asarray(pins), jnp.asarray(mask))))
    got = hpwl.hpwl(torch.as_tensor(pins), torch.as_tensor(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[mask.sum(axis=1) == 0] == 0).all()


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers take the plain path: no kernel library
    is built and no launch is counted."""
    build.reset_launch_counts()
    d, w = minplus_case(0, 2, 10)
    minplus.minplus_wavefront(torch.as_tensor(d), torch.as_tensor(w))
    pins, mask = bbox_case(0, 5, 3)
    hpwl.net_bboxes(torch.as_tensor(pins), torch.as_tensor(mask))
    hpwl.hpwl(torch.as_tensor(pins), torch.as_tensor(mask))
    vals, src, sel = map(torch.as_tensor, sweep_case(0, 2, 10, 3))
    fabric_step.fabric_sweep(vals[0], src, sel[0])
    fabric_step.fabric_sweep_batch(vals, src, sel)
    assert all(v == 0 for v in build.LAUNCHES.values())


def block_bytes(n, cluster, room, pred=False):
    """A block's shared memory in the fused kernels' cluster variant."""
    rec = fabric_step.PRED_REC_BYTES if pred else fabric_step.REC_BYTES
    return (fabric_step.SLOT_BYTES * -(-(n + 1) // cluster) + rec * room
            + fabric_step.COUNT_BYTES)


def rv_block_bytes(n, cluster, room):
    """A block's shared memory in ``rv_sweeps``: the forward layout (12 B a
    slot, 32 B a record) or the ready one (16 B a slot), whichever is
    larger, over ceil((N + 1) / C) slots rounded up to 4."""
    chunk = (-(-(n + 1) // cluster) + 3) & ~3
    return max(12 * chunk + 32 * room, 16 * chunk)


def every(room):
    """Rooms where each block is charged ``room`` records."""
    return dict.fromkeys(cluster_plan.LADDER, room)


#: counted rooms: FULL's order (208 records a block at 8 blocks, the same
#: in either kernel's slot ranges) and the two-layer array's (208 at 16)
FULL_ROOMS = {1: 1560, 2: 780, 4: 414, 8: 208, 16: 104}
TWO_ROOMS = {1: 2340, 2: 1170, 4: 828, 8: 414, 16: 208}
#: (N, rooms, cluster) each layout's plan gives: the limits of every
#: cluster size without records, FULL's 8 blocks and the two-layer array's
#: 16 at their counted rooms, limits with every PE's records in each block
PLAN_CASES = {
    "fused": (block_bytes, [
        *zip((0, 1, 5000, 14526, 14527, 29053, 29054, 58107, 58108, 86288,
              116215, 116216, 232431, 232432, 10 ** 6), [every(0)] * 15,
             (1, 1, 1, 1, 2, 2, 4, 4, 8, 8, 8, 16, 16, 0, 0)),
        (86288, FULL_ROOMS, 8), (86288, every(1560), 8),
        (91255, every(1560), 8), (91256, every(1560), 16),
        (182511, every(1560), 16), (182512, every(1560), 0),
        (5000, every(7264), 0)]),                # no room for one slot
    "fused_pred": (functools.partial(block_bytes, pred=True), [
        (179312, TWO_ROOMS, 16), (179312, every(2340), 0),
        (86288, every(2340), 16), (7506, every(2340), 1),
        (7507, every(2340), 2), (60055, every(2340), 8),
        (60056, every(2340), 16), (120111, every(2340), 16),
        (120112, every(2340), 0)]),
    "rv": (rv_block_bytes, [
        *zip((0, 1192, 14527, 14528, 29055, 29056, 58111, 58112, 86288,
              116223, 116224, 232447, 232448, 10 ** 6), [every(0)] * 14,
             (1, 1, 1, 2, 2, 4, 4, 8, 8, 8, 16, 16, 0, 0)),
        (86288, FULL_ROOMS, 8), (116223, every(1560), 8),
        (116224, every(1560), 16),
        (5000, every(7264), 0),                  # no room for one slot
        (5000, {1: 6000, 2: 3000, 4: 1500, 8: 750, 16: 375}, 2)]),
}


@pytest.mark.parametrize("layout", sorted(PLAN_CASES))
def test_cluster_plan_size_rule(layout, monkeypatch):
    """The cluster kernels' one size rule, on each kernel's layout
    (``fabric_step.fused_block_bytes``, with the 1-bit inputs, and
    ``rv_sweep.rv_block_bytes``) and the rooms given: the smallest cluster
    of 1, 2, 4, 8, 16 blocks whose block fits 227 KB, 0 past 16. A
    16-block cluster only where the card holds one; below 16 the card is
    never asked."""
    fn, cases = PLAN_CASES[layout]
    layout_bytes = {"fused": fabric_step.fused_block_bytes,
                    "fused_pred": functools.partial(
                        fabric_step.fused_block_bytes, pred=True),
                    "rv": rv_sweep.rv_block_bytes}[layout]
    for n, rooms, want in cases:
        def size(c, room):
            assert layout_bytes(n, c, room) == fn(n, c, room)
            return fn(n, c, room)
        asked = []
        got = cluster_plan.plan(size, rooms,
                                lambda c, room: asked.append(c) or 1)
        assert got == ((want, rooms[want]) if want else (0, 0)), (n, want)
        assert asked == ([16] if want == 16 else [])
        if want:
            assert size(want, rooms[want]) <= cluster_plan.BLOCK_SMEM_BYTES
            assert want == 1 or size(want // 2, rooms[want // 2]) > \
                cluster_plan.BLOCK_SMEM_BYTES
        if want == 16:
            assert cluster_plan.plan(size, rooms, lambda c, r: 0) == (0, 0)
    assert cluster_plan.BLOCK_SMEM_BYTES == 232_448
    # FULL at 8 blocks and the two-layer array at 16, in less shared memory
    # than with every record charged; 4 (8) blocks would need past 227 KB
    assert block_bytes(86288, 8, 208) == 179_264
    assert block_bytes(86288, 4, 414) > cluster_plan.BLOCK_SMEM_BYTES
    assert block_bytes(179312, 16, 208, pred=True) == 189_328
    assert block_bytes(179312, 8, 414, pred=True) == 378_528
    assert rv_block_bytes(86288, 8, 208) == 172_608
    assert rv_block_bytes(86288, 4, 414) == 345_216


def host_rooms(src, pe_res_idx, n_res):
    """The most PE outputs in one block's slot range for each cluster
    size, counted on the host from the order's definition (key min(i,
    src[i, :]), ties in node order); and the per-block counts."""
    n = src.shape[0]
    key = np.minimum(np.arange(n), src.min(axis=1)) if src.shape[1] else \
        np.arange(n)
    slot = np.empty(n, np.int64)
    slot[np.argsort(key, kind="stable")] = np.arange(n)
    counts = {}
    for c in cluster_plan.LADDER:
        chunk = -(-(n + 1) // c)
        counts[c] = np.bincount(slot[pe_res_idx < n_res] // chunk,
                                minlength=c)
    return {c: int(v.max()) for c, v in counts.items()}, counts


@pytest.mark.parametrize("seed,n,f,p", [(0, 300, 6, 16), (1, 2000, 20, 200),
                                        (2, 17, 3, 2), (3, 5000, 4, 0),
                                        (4, 40000, 20, 2000)])
def test_fused_rooms_count_each_blocks_pe_outputs(seed, n, f, p):
    """A block's record room, for every cluster size of 1-16 blocks, is
    the most PE outputs any block's slot range holds: the records the
    kernel appends there, so none lands past the room. Kept per table
    pair, and counted again after an in-place change."""
    case = fabric_case(seed, b=1, n=n, f=f, p=p)
    src = torch.as_tensor(case["src"])
    res = torch.as_tensor(case["pe_res_idx"])
    rooms = fabric_step.fused_rooms(src, res, 2 * p)
    assert rooms == host_rooms(case["src"], case["pe_res_idx"], 2 * p)[0]
    assert fabric_step.fused_rooms(src, res, 2 * p) is rooms
    assert rooms[1] == 2 * p
    res[: n // 2] = 2 * p                      # half the outputs go
    again = fabric_step.fused_rooms(src, res, 2 * p)
    assert again == host_rooms(case["src"], res.numpy(), 2 * p)[0]


def tight_case(seed, b, n, r, cluster=16, f=20, t_len=4):
    """Random fused tables (``fabric_case``) whose PE outputs lie r in
    each block's slot range of a ``cluster``-block lane: every block
    holds exactly the counted room."""
    p = cluster * r // 2
    case = fabric_case(seed, b=b, n=n, f=f, p=p, t_len=t_len)
    node_of = cluster_plan.order(torch.as_tensor(case["src"]))[0]
    node_of = node_of.numpy()
    chunk = -(-(n + 1) // cluster)
    rng = np.random.default_rng(seed)
    pe_nodes = rng.permutation(np.concatenate([
        rng.choice(node_of[k * chunk:(k + 1) * chunk], r, replace=False)
        for k in range(cluster)]))
    case["pe_res_idx"] = np.full(n, 2 * p, np.int32)
    case["pe_res_idx"][pe_nodes] = np.arange(2 * p, dtype=np.int32)
    case["pe_out"] = pe_nodes.reshape(p, 2).astype(np.int32)
    return case


#: N 120,000 in 16 blocks of 7,501 slots, with 3,513 records each, fills a
#: block's 232,448 B exactly
TIGHT = dict(n=120000, r=3513)


def test_the_tightest_room_fills_a_block_exactly(monkeypatch):
    """Where every block holds r PE outputs, the room is r, the 16-block
    lane's blocks take every byte of shared memory, and one record more
    would not fit."""
    n, r = TIGHT["n"], TIGHT["r"]
    case = tight_case(0, 1, n, r)
    p = case["pe_in"].shape[0]
    rooms, counts = host_rooms(case["src"], case["pe_res_idx"], 2 * p)
    assert (counts[16] == r).all() and rooms[16] == r
    t = {k: torch.as_tensor(case[k]) for k in ("src", "pe_res_idx",
                                               "pe_in")}
    assert fabric_step.fused_rooms(t["src"], t["pe_res_idx"], 2 * p) == rooms
    assert block_bytes(n, 16, r) == cluster_plan.BLOCK_SMEM_BYTES

    def size(c, room):
        return fabric_step.fused_block_bytes(n, c, room)
    assert cluster_plan.plan(size, rooms, lambda c, room: 1) == (16, r)
    assert cluster_plan.plan(size, {**rooms, 16: r + 1},
                             lambda c, room: 1) == (0, 0)
    monkeypatch.setattr(cluster_plan, "active_clusters", lambda *a: 1)
    assert fabric_step.fused_plan("fabric_fused_run", t["src"],
                                  t["pe_res_idx"], t["pe_in"]) == (16, r)


def test_fused_plan_takes_16_blocks_where_the_card_holds_one(monkeypatch):
    """The plan asks the card (``active_clusters``) only for a
    non-portable 16-block cluster, at the counted room, and takes the
    global-memory variant where the card holds none; 1-8 blocks never
    ask."""
    case = fabric_case(5, b=1, n=120000, f=4, p=200)
    t = {k: torch.as_tensor(case[k]) for k in ("src", "pe_res_idx",
                                               "pe_in")}
    room = fabric_step.fused_rooms(t["src"], t["pe_res_idx"], 400)[16]
    asked = []
    monkeypatch.setattr(cluster_plan, "active_clusters",
                        lambda *a: asked.append(a) or 7)
    plan = fabric_step.fused_plan("fabric_fused_run", t["src"],
                                  t["pe_res_idx"], t["pe_in"])
    assert plan == (16, room) and 0 < room < 400
    assert asked == [("fabric_fused_run", 120000, 16, room, False)]
    monkeypatch.setattr(cluster_plan, "active_clusters", lambda *a: 0)
    assert fabric_step.fused_plan("fabric_fused_batch", t["src"],
                                  t["pe_res_idx"], t["pe_in"]) == (0, 0)

    def never(*a):
        raise AssertionError("asked the card below 16 blocks")
    monkeypatch.setattr(cluster_plan, "active_clusters", never)
    small = fabric_case(6, b=1, n=60000, f=4, p=200)
    t = {k: torch.as_tensor(small[k]) for k in ("src", "pe_res_idx",
                                                "pe_in")}
    cluster, room = fabric_step.fused_plan("fabric_fused_run", t["src"],
                                           t["pe_res_idx"], t["pe_in"])
    assert cluster == 8 and room == host_rooms(small["src"],
                                               small["pe_res_idx"], 400)[0][8]


#: (B, N, F): the Amber FULL size at verify's chunk, the unfused
#: engine's B 8 and B 1; batches past the grid's 65,535 rows; F at the
#: limit of a 256-node tile and past it, and the widest a 4-node tile
#: holds; small and ragged shapes
SWEEP_SHAPES = [(2048, 86288, 20), (8, 86288, 20), (1, 86288, 20),
                (4096, 86288, 20), (1001, 5000, 20), (40, 5001, 20),
                (33, 3000, 1), (70000, 3, 2), (65535 * 32 + 5, 700, 6),
                (2048, 5000, 227), (2048, 5000, 229), (1, 1, 1), (5, 513, 1000),
                (2, 9, 14527)]


@pytest.mark.parametrize("b,n,f", SWEEP_SHAPES)
def test_sweep_batch_tiles_fit_and_cover(b, n, f):
    """``fabric_sweep_batch``'s size rule: the staged tile fits 227 KB
    of shared memory, and the blocks, modelled as the kernel walks them
    (tile x of TN nodes, 4 a thread; groups y, y + grid_y, ... of BB
    configurations, each shared by the block's lanes), cover every (b, i)
    exactly once."""
    tn, lanes, bb, grid_y, smem = fabric_step.sweep_batch_tiles(b, n, f)
    assert 4 <= tn <= fabric_step.SWEEP_TILE and tn & (tn - 1) == 0
    assert 1 <= lanes <= bb
    assert bb <= fabric_step.SWEEP_GROUP and tn // 4 * lanes <= 512
    assert 1 <= grid_y <= fabric_step.MAX_GRID_Y
    assert smem == 4 * tn * (f | 1) <= fabric_step.BLOCK_SMEM_BYTES
    if tn < min(fabric_step.SWEEP_FILL_TILE, n):  # only the fit shrinks it
        assert 8 * tn * (f | 1) > fabric_step.BLOCK_SMEM_BYTES
    nodes = np.zeros(n, np.int64)
    for x in range(-(-n // tn)):
        for t in range(tn // 4):               # the block's threads
            lo = x * tn + 4 * t
            nodes[lo:min(lo + 4, x * tn + tn, n)] += 1
    configs = np.zeros(b, np.int64)
    for y in range(grid_y):
        for g0 in range(y * bb, b, grid_y * bb):
            for lane in range(lanes):
                configs[g0 + lane:min(b, g0 + bb):lanes] += 1
    assert (nodes == 1).all() and (configs == 1).all()


@pytest.mark.parametrize("f", [14528, 100000])
def test_sweep_batch_tiles_refuse_a_fan_in_past_four_nodes(f):
    """A fan-in whose src rows for 4 nodes overflow shared memory has no
    tile: the size rule raises rather than launch a kernel that cannot
    stage it."""
    with pytest.raises(ValueError, match="fan-in"):
        fabric_step.sweep_batch_tiles(8, 1000, f)


@pytest.mark.parametrize("b", [1, 8, 2048])
def test_sweep_batch_tiles_fill_the_card_at_full(b):
    """At the Amber FULL size the grid has at least one block for each
    of an H100's 132 SMs, at the unfused engine's B 8 and at B 1 too."""
    tn, lanes, bb, grid_y, smem = fabric_step.sweep_batch_tiles(b, 86288,
                                                                 20)
    assert -(-86288 // tn) * grid_y >= 132
    assert smem == 4 * tn * 21


@pytest.mark.parametrize("seed,n,f", [(0, 300, 6), (1, 1, 1), (2, 700, 20)])
def test_fused_order_is_a_permutation(seed, n, f):
    """The cluster variant's node order: ``node_of`` a permutation of the
    nodes, ``slot_of`` its inverse with the sentinel N kept at slot N, and
    every node placed by its key min(i, src[i, :]) in ascending order."""
    _, src, _ = sweep_case(seed, 1, n, f)
    node_of, slot_of = cluster_plan.order(torch.as_tensor(src))
    node_of, slot_of = node_of.numpy(), slot_of.numpy()
    assert node_of.dtype == np.int32 and slot_of.dtype == np.int32
    assert sorted(node_of.tolist()) == list(range(n))
    assert slot_of[n] == n
    np.testing.assert_array_equal(slot_of[node_of], np.arange(n))
    key = np.minimum(np.arange(n), src.min(axis=1))[node_of]
    assert (np.diff(key) >= 0).all()



def test_fused_order_is_kept_per_source_table():
    """The order is computed once per ``src`` tensor, and again after the
    tensor is modified in place."""
    _, src, _ = sweep_case(3, 1, 200, 5)
    src = torch.as_tensor(src)
    first = cluster_plan.order(src)
    assert cluster_plan.order(src)[0] is first[0]
    src[:, :] = torch.flip(src, [0])
    again = cluster_plan.order(src)
    assert again[0] is not first[0]
    key = torch.minimum(torch.arange(200), src.amin(1))[again[0].long()]
    assert bool((key[1:] >= key[:-1]).all())


def test_cpu_fused_wrappers_launch_nothing():
    """The fused wrappers take their plain versions on CPU tensors: no
    library is built, no launch is counted, and the results equal the
    plain versions called directly."""
    build.reset_launch_counts()
    case = fabric_case(11, b=3, n=200, t_len=3)
    kw = {k: case[k] for k in RUN_KW}
    got = fabric_step.fabric_fused_batch(*_t(case, BATCH_ARGS), max_depth=5)
    want = fabric_step.fabric_fused_batch_plain(*_t(case, BATCH_ARGS),
                                                max_depth=5)
    assert torch.equal(got, want)
    got = fabric_step.fabric_fused_run(*_t(case, RUN_ARGS), **kw,
                                       max_depth=5)
    want = fabric_step.fabric_fused_run_plain(*_t(case, RUN_ARGS), **kw,
                                              max_depth=5)
    assert torch.equal(got, want)
    assert all(v == 0 for v in build.LAUNCHES.values())


# ------------------------------------------------------- the LM kernels
@pytest.fixture(scope="module")
def jlm():
    """The reference's LM kernel entry points (interpret mode here)."""
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    return jops


def attention_case(sq, skv, hq, hkv, d=64, b=2, seed=None):
    """The reference test's inputs: N(0, 1) q, k, v (b, h, s, d)."""
    rng = np.random.default_rng(sq + skv if seed is None else seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


#: the reference test's shapes (tests/test_kernels.py:177-182)
FLASH_CASES = [(128, 128, 4, 4, "float32"), (200, 200, 4, 2, "float32"),
               (256, 256, 8, 1, "bfloat16"), (130, 384, 2, 2, "float32")]


@pytest.mark.parametrize("sq,skv,hq,hkv,dtype", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(jlm, sq, skv, hq, hkv, dtype):
    """GQA wrapper on the plain path vs the Pallas kernel in interpret
    mode, and vs the float64 oracle, at the reference test's tolerance
    (2e-2 in bf16: one bf16 rounding of outputs below 4; 2e-5 in f32)."""
    import jax.numpy as jnp
    q, k, v = attention_case(sq, skv, hq, hkv)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jlm.flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    qt, kt, vt = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    got = flash_attention.flash_attention_gqa(qt, kt, vt, causal=True)
    assert got.dtype == tdt and got.shape == qt.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)
    rep = hq // hkv
    oracle = ref.attention_ref(
        qt.double().reshape(-1, sq, 64),
        kt.double().repeat_interleave(rep, 1).reshape(-1, skv, 64),
        vt.double().repeat_interleave(rep, 1).reshape(-1, skv, 64))
    np.testing.assert_allclose(got.float().numpy(),
                               oracle.reshape(got.shape).numpy(), atol=tol,
                               rtol=tol)


def test_flash_attention_full_matches_pallas(jlm):
    """Non-causal attention, head dim 128, against the reference's kernel
    function on batch*heads pre-flattened (as it takes them)."""
    from repro.kernels import flash_attention as jfa
    import jax.numpy as jnp
    q, k, v = attention_case(70, 150, 3, 3, d=128, b=1, seed=9)
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(a[0]) for a in (q, k, v)), causal=False,
        interpret=True))
    got = flash_attention.flash_attention_gqa(
        *map(torch.as_tensor, (q, k, v)), causal=False)
    np.testing.assert_allclose(got[0].numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", [96, 112])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_new_head_dims_match_pallas(jlm, d, dtype):
    """Head dims 96 (Phi-3) and 112 (Kimi K2) on the plain path against
    the Pallas kernel in interpret mode (which takes any head dim) and
    the float64 oracle, GQA and a ragged length, at the reference test's
    tolerances."""
    import jax.numpy as jnp
    q, k, v = attention_case(200, 200, 4, 2, d=d, seed=d)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jlm.flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal=True).astype(jnp.float32))
    qt, kt, vt = (torch.as_tensor(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = flash_attention.flash_attention_gqa(qt, kt, vt, causal=True)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)
    oracle = ref.attention_ref(
        qt.double().reshape(-1, 200, d),
        kt.double().repeat_interleave(2, 1).reshape(-1, 200, d),
        vt.double().repeat_interleave(2, 1).reshape(-1, 200, d))
    np.testing.assert_allclose(got.float().numpy(),
                               oracle.reshape(got.shape).numpy(), atol=tol,
                               rtol=tol)


def tensor_core_model(q, k, v, causal, keys=128, split=True,
                      scale_d=None):
    """The 16-bit tensor-core kernel's rounding, in float32 torch: per
    tile of ``keys`` keys, S = Q K^T of the 16-bit values with float32
    sums, then scaled; the online softmax in float32; P carried as two
    terms of q's dtype (bf16 or f16) hi = T(p), lo = T(p - hi) (only hi
    with ``split=False``), each multiplied by V with float32 sums; the
    output divided by max(l, 1e-30) and rounded to q's dtype.
    ``scale_d``: the head dim of the scale, where the inputs are padded
    past it."""
    tdt = q.dtype
    b, hq, sq, d = q.shape
    rep = hq // k.shape[1]
    k, v = (t.repeat_interleave(rep, 1).float() for t in (k, v))
    skv = k.shape[2]
    d = scale_d or d
    q = q.float()
    m = torch.full((b, hq, sq, 1), flash_attention.NEG_INF)
    den = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, q.shape[-1]))
    qi = torch.arange(sq)[:, None]
    for k0 in range(0, skv, keys):
        kt, vt = k[:, :, k0:k0 + keys], v[:, :, k0:k0 + keys]
        s = (q @ kt.transpose(-1, -2)) * (1.0 / d ** 0.5)
        if causal:
            ki = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(qi < ki, flash_attention.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        hi = p.to(tdt).float()
        lo = (p - hi).to(tdt).float() if split else torch.zeros_like(p)
        acc = acc * alpha + hi @ vt + lo @ vt
        m = m_new
    return (acc / den.clamp_min(1e-30)).to(tdt)


@pytest.mark.parametrize("d", [96, 112])
def test_flash_attention_padded_tile_keeps_the_tolerance(d):
    """The tensor-core kernel's route for D 96 and 112, without the card:
    q, k and v padded with zero columns to the tile width of 128 (TMA's
    out-of-bounds fill), 64-key tiles, the scale of the true D, the
    first D output columns kept. The zero columns add nothing to Q K^T
    or P V, so the result stays within the card tests' bf16 tolerance of
    the plain version at D, and the padded columns come out zero."""
    q, k, v = (torch.as_tensor(a).bfloat16()
               for a in attention_case(300, 300, 4, 2, d=d, b=1, seed=d))
    pad = [torch.nn.functional.pad(t, (0, 128 - d)) for t in (q, k, v)]
    got = tensor_core_model(*pad, causal=True, keys=64, scale_d=d)
    assert not got[..., d:].any()
    want = flash_attention.flash_attention_gqa_plain(q, k, v, causal=True)
    torch.testing.assert_close(got[..., :d].float(), want.float(),
                               atol=1e-4, rtol=2.0 ** -7)


@pytest.mark.parametrize("d,width,keys", [(16, 64, 128), (20, 64, 128),
                                          (256, 256, 64), (200, 256, 64)])
def test_flash_attention_new_tiles_keep_the_tolerance(d, width, keys):
    """The tensor-core routes of the other head dims, without the card:
    D 16 and 20 at the tile width of 64 (128-key tiles; 20 copied to a
    row of 24 first), D 200 and 256 at the width of 256 (64-key tiles),
    the columns past D zero, the scale of the true D: within the card
    tests' bf16 tolerance of the plain version, the padded columns zero."""
    q, k, v = (torch.as_tensor(a).bfloat16()
               for a in attention_case(150, 150, 4, 2, d=d, b=1, seed=d))
    pad = [torch.nn.functional.pad(t, (0, width - d)) for t in (q, k, v)]
    got = tensor_core_model(*pad, causal=True, keys=keys, scale_d=d)
    assert not got[..., d:].any()
    want = flash_attention.flash_attention_gqa_plain(q, k, v, causal=True)
    torch.testing.assert_close(got[..., :d].float(), want.float(),
                               atol=1e-4, rtol=2.0 ** -7)


def test_flash_attention_f16_hi_lo_keeps_one_f16_ulp():
    """The float16 instantiation's precision argument, without the card:
    P as two f16 terms keeps the output within one f16 ulp of the plain
    version (1e-4 + 2^-10 |want|), at the LM path's tile and a mid shape
    with GQA; P rounded once to f16 does not."""
    q, k, v = (torch.as_tensor(a).half()
               for a in attention_case(512, 512, 4, 2, b=1, seed=15))
    want = flash_attention.flash_attention_gqa_plain(q, k, v, causal=True)
    got = tensor_core_model(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2.0 ** -10)
    one_term = tensor_core_model(q, k, v, causal=True, split=False)
    assert not torch.allclose(one_term.float(), want.float(), atol=1e-4,
                              rtol=2.0 ** -10)


def test_flash_attention_hi_lo_probabilities_keep_the_tolerance():
    """The precision argument of the bf16 tensor-core kernel, without the
    card: its rounding (bf16 products summed in float32, P as bf16
    hi + lo) stays within the card tests' bf16 tolerance of the plain
    version (1e-4 + 2^-7 |want|: one bf16 ulp of the output), at a mid
    shape with GQA; P rounded once to bf16 does not."""
    q, k, v = (torch.as_tensor(a).bfloat16()
               for a in attention_case(512, 512, 4, 2, b=1, seed=14))
    want = flash_attention.flash_attention_gqa_plain(q, k, v, causal=True)
    got = tensor_core_model(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2.0 ** -7)
    one_term = tensor_core_model(q, k, v, causal=True, split=False)
    assert not torch.allclose(one_term.float(), want.float(), atol=1e-4,
                              rtol=2.0 ** -7)


def ssd_case(bh, l, p, n, seed):
    """The reference test's inputs: dt in [0.1, 0.6), a in (-1.5, -0.5],
    b and c 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, l, p)).astype(np.float32),
            (0.1 + rng.random((bh, l)) * 0.5).astype(np.float32),
            (-0.5 - rng.random(bh)).astype(np.float32),
            (rng.standard_normal((bh, l, n)) * 0.3).astype(np.float32),
            (rng.standard_normal((bh, l, n)) * 0.3).astype(np.float32))


#: the reference test's shapes (tests/test_kernels.py:205-207), L 100
#: padded to a multiple of its chunk
@pytest.mark.parametrize("l,chunk,p,n", [(128, 64, 8, 4), (256, 128, 16, 8),
                                         (100, 32, 4, 4)])
def test_ssd_scan_plain_matches_pallas(jlm, l, chunk, p, n):
    import jax.numpy as jnp
    args = ssd_case(3, l, p, n, seed=l)
    want = np.asarray(jlm.ssd_scan(*map(jnp.asarray, args), chunk=chunk))
    got = ssd_scan.ssd_scan(*map(torch.as_tensor, args), chunk=chunk)
    assert got.shape == (3, l, p)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    oracle = ref.ssd_ref(*(torch.as_tensor(a).double() for a in args))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=2e-4,
                               rtol=2e-4)


def _shuffle_scan(v, width=32):
    """Inclusive cumsum over the last axis in the kernel's order: a
    Hillis-Steele scan within each run of ``width`` (a warp), then the
    earlier runs' totals added one by one."""
    runs = v.reshape(*v.shape[:-1], -1, width).clone()
    o = 1
    while o < width:
        runs[..., o:] = runs[..., o:] + runs[..., :-o].clone()
        o *= 2
    totals = runs[..., -1]
    off = torch.zeros_like(totals)
    for w in range(1, totals.shape[-1]):
        off[..., w] = off[..., w - 1] + totals[..., w - 1]
    return (runs + off[..., None]).reshape(v.shape)


def three_pass_ssd(x, dt, a, b, c, chunk):
    """A float32 model of ``csrc/ssd_scan.cu``'s order of work: (1) every
    chunk's own state contribution, independently; (2) the carry of the
    start states over the chunks; (3) every chunk's outputs from its start
    state and its causal triangle."""
    bh, l, p = x.shape
    n = b.shape[-1]
    k = -(-l // chunk)
    pad = k * chunk - l

    def chunks(t):
        t = torch.cat([t, t.new_zeros((bh, pad) + t.shape[2:])], dim=1)
        return t.reshape(bh, k, chunk, *t.shape[2:])
    xs, dts, bs, cs = map(chunks, (x, dt, b, c))
    seg = _shuffle_scan(dts * a[:, None, None])            # (BH, K, C)
    seg_last = seg[..., -1]
    coef = dts * torch.exp(seg_last[..., None] - seg)
    own = torch.einsum("bkun,bkup->bknp", bs, xs * coef[..., None])
    h = torch.zeros((bh, n, p), dtype=torch.float32)
    starts = []
    for j in range(k):
        starts.append(h)
        h = torch.exp(seg_last[:, j])[:, None, None] * h + own[:, j]
    start = torch.stack(starts, dim=1)                     # (BH, K, N, P)
    scores = torch.einsum("bktn,bkun->bktu", cs, bs)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    decay = torch.where(causal, torch.exp(seg[..., :, None]
                                          - seg[..., None, :]),
                        torch.zeros(()))
    w = scores * decay * dts[..., None, :]
    y = (torch.einsum("bktn,bknp->bktp", cs, start)
         * torch.exp(seg)[..., None] + w @ xs)
    return y.reshape(bh, k * chunk, p)[:, :l]


@pytest.mark.parametrize("l", [1, 100, 300])
@pytest.mark.parametrize("n", [4, 16])
def test_ssd_three_pass_order_matches_reference(jlm, l, n):
    """The CUDA kernel's split (independent chunk states, the carry, then
    the outputs) and its warp-scan cumsum stay within 1e-5 of the
    reference kernel (interpret mode) and of the float64 recurrence."""
    import jax.numpy as jnp
    from repro.kernels import ssd_scan as jssd
    args = ssd_case(3, l, 8, n, seed=l + n)
    got = three_pass_ssd(*map(torch.as_tensor, args), chunk=32)
    want = np.asarray(jssd.ssd_scan(*map(jnp.asarray, args), chunk=32,
                                    interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    oracle = ref.ssd_ref(*(torch.as_tensor(a).double() for a in args))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_lm_oracles_match_reference(jlm):
    """The port's float oracles against the reference's, in float32."""
    from repro.kernels import ref as jr
    import jax.numpy as jnp
    q, k, v = (a.reshape(-1, a.shape[2], 64)
               for a in attention_case(40, 40, 2, 2))
    np.testing.assert_allclose(
        ref.attention_ref(*map(torch.as_tensor, (q, k, v))).numpy(),
        np.asarray(jr.attention_ref(*map(jnp.asarray, (q, k, v)))),
        atol=1e-5, rtol=1e-5)
    args = ssd_case(2, 50, 4, 3, seed=5)
    np.testing.assert_allclose(
        ref.ssd_ref(*map(torch.as_tensor, args)).numpy(),
        np.asarray(jr.ssd_ref(*map(jnp.asarray, args))), atol=1e-5,
        rtol=1e-5)


@pytest.mark.parametrize("d,dtype,want", [
    (64, torch.bfloat16, ("tensor_core", 64, 64)),
    (16, torch.bfloat16, ("tensor_core", 64, 16)),
    (8, torch.float16, ("tensor_core", 64, 8)),
    (1, torch.bfloat16, ("tensor_core", 64, 8)),
    (20, torch.float16, ("tensor_core", 64, 24)),
    (96, torch.bfloat16, ("tensor_core", 128, 96)),
    (100, torch.bfloat16, ("tensor_core", 128, 104)),
    (112, torch.float16, ("tensor_core", 128, 112)),
    (128, torch.bfloat16, ("tensor_core", 128, 128)),
    (129, torch.bfloat16, ("tensor_core", 256, 136)),
    (256, torch.float16, ("tensor_core", 256, 256)),
    (1, torch.float32, ("cuda_core", 32, 1)),
    (96, torch.float32, ("cuda_core", 96, 96)),
    (100, torch.float32, ("cuda_core", 128, 100)),
    (256, torch.float32, ("cuda_core", 256, 256)),
    (257, torch.bfloat16, ("cuda_core", 256, 257)),
    (320, torch.float16, ("cuda_core", 256, 320)),
    (384, torch.float32, ("cuda_core", 256, 384)),
    (511, torch.bfloat16, ("cuda_core", 256, 511)),
    (512, torch.float32, ("cuda_core", 256, 512)),
])
def test_flash_attention_plans_every_head_dim(d, dtype, want):
    """What the flash wrapper plans for a head dim: the kernel, its tile
    width (columns past D read as zeros) and the row width it hands the
    kernel (a 16-bit row padded with zero columns to a multiple of 8,
    16 bytes, where TMA needs it)."""
    assert tuple(flash_attention.plan(d, dtype)) == want


@pytest.mark.parametrize("chunk,p,n,want", [
    (128, 64, 128, ((128, 64, 128), 1, 1)),    # Mamba2
    (32, 16, 16, ((32, 16, 16), 1, 1)),        # the smoke configs
    (64, 16, 16, ((32, 16, 16), 1, 1)),        # another chunk
    (32, 8, 4, ((32, 16, 16), 1, 1)),          # P and N zero-padded
    (32, 17, 16, ((128, 64, 128), 1, 1)),
    (128, 32, 100, ((128, 64, 128), 1, 1)),
    (128, 64, 256, ((128, 64, 128), 1, 2)),    # N in blocks, summed
    (32, 130, 16, ((128, 64, 128), 3, 1)),     # P in blocks
])
def test_ssd_scan_plans_every_shape(chunk, p, n, want):
    """What the SSD wrapper plans for a (chunk, P, N): the instantiation
    (the asked chunk where one holds P and N, else the smallest that
    does) and the blocks of P and N it runs."""
    assert tuple(ssd_scan.plan(chunk, p, n)) == want


def test_lm_kernel_wrappers_refuse_only_what_no_kernel_takes():
    """The launch paths check before they build or launch anything: a head
    dim under 1 (every head dim from 1 runs: past 256 on the panel
    kernel), a dtype no kernel takes, GQA heads that do not divide;
    zero-size inputs launch nothing."""
    for d in (257, 300, 512):
        assert flash_attention.plan(d, torch.bfloat16).mem_dim == d
    qd = torch.zeros((1, 2, 4, 0), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention._launch(qd, qd, qd, True)
    q = torch.zeros((1, 2, 4, 32))
    with pytest.raises(TypeError):
        flash_attention._launch(q.double(), q.double(), q.double(), True)
    with pytest.raises(ValueError, match="is on meta"):
        flash_attention._launch(q, q.to("meta"), q, True)
    q3, k2 = torch.zeros((1, 3, 4, 32)), torch.zeros((1, 2, 4, 32))
    with pytest.raises(ValueError, match="not a multiple"):
        flash_attention._launch(q3, k2, k2, True)
    x, dt, a, b, c = map(torch.as_tensor, ssd_case(2, 16, 8, 4, seed=1))
    build.reset_launch_counts()
    flash_attention.flash_attention_gqa(q[:, :, :0], q[:, :, :0], q[:, :, :0])
    ssd_scan.ssd_scan(x, dt, a, b, c, chunk=8)
    assert build.LAUNCHES["flash_attention"] == 0
    assert build.LAUNCHES["ssd_scan"] == 0


def mixed_depths(b, max_depth, seed=0):
    """Per-lane depths mixing 0, 1, ``max_depth`` and more than it."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, max_depth + 4, b)
    d[:4] = [0, 1, max_depth, max_depth + 3][:b]
    return d.astype(np.int32)


#: (N, B, word, cluster): the fused kernels' cluster variant at 1, 2, 4, 8
#: and 16 blocks a lane (at N 60,000 a lane spans every block of its
#: cluster and reads the others' shared memory; N 120,000 at P 200 takes 16
#: by its counted room), B 40 above the clusters the card holds at once
#: (the rest queue), and N 250,000 past the size rule's limit (the
#: global-memory variant, 0)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 255, 256, 1023, 1024,
                               4097, 33791, 33792, 86288, 2 ** 20 - 1,
                               2 ** 20, 2 ** 22 + 3])
def test_sweep_tiles_cover_once_and_fill_one_wave(n):
    """``fabric_sweep``'s size rule: its grid, modelled as the kernel
    walks it (node groups of ``SWEEP_NODES`` t, t + S, ..., then the tail
    nodes one at a time; all nodes one at a time when unaligned), covers
    every node exactly once; it is one wave (every block resident at
    once on an H100), spread over every SM where the groups allow, and
    as large as the groups need up to that wave."""
    blocks, threads = fabric_step.sweep_tiles(n)
    v, sms = fabric_step.SWEEP_NODES, fabric_step.SM_COUNT
    assert threads in (64, 128, 256) and blocks >= 1
    assert blocks * threads <= sms * fabric_step.SM_THREADS
    work = -(-n // v)
    assert blocks == min(-(-work // threads),
                         sms * fabric_step.SM_THREADS // threads)
    assert blocks >= min(sms, -(-work // fabric_step.SWEEP_MIN_THREADS))
    s = blocks * threads
    t = np.arange(s)
    for aligned in (True, False):
        seen = np.zeros(n, np.int64)
        groups = n // v if aligned else 0
        for k in range(-(-groups // s)):
            g = t + k * s
            g = g[g < groups]
            np.add.at(seen, (v * g[:, None] + np.arange(v)).ravel(), 1)
        for k in range(-(-(n - v * groups) // s)):
            i = v * groups + t + k * s
            np.add.at(seen, i[i < n], 1)
        assert (seen == 1).all()


def test_fabric_sweep_out_on_the_cpu():
    """``out=`` on the plain path: the same values as without it, written
    into and returned as ``out``; a wrong shape or type, or an ``out``
    that overlaps ``vals_ext``, is refused."""
    vals, src, sel = map(torch.as_tensor, sweep_case(8, 1, 300, 6))
    vals, sel = vals[0], sel[0]
    want = fabric_step.fabric_sweep(vals, src, sel)
    out = torch.full((300,), -7, dtype=torch.int32)
    assert fabric_step.fabric_sweep(vals, src, sel, out=out) is out
    assert torch.equal(out, want)
    assert torch.equal(fabric_step.fabric_sweep_plain(vals, src, sel,
                                                      out=out), want)
    with pytest.raises(ValueError, match="shape"):
        fabric_step.fabric_sweep(vals, src, sel,
                                 out=torch.empty(299, dtype=torch.int32))
    with pytest.raises(TypeError, match="int64"):
        fabric_step.fabric_sweep(vals, src, sel,
                                 out=torch.empty(300, dtype=torch.int64))
    buf = torch.cat([vals, torch.zeros(300, dtype=torch.int32)])
    for view in (buf[:300], buf[1:301], buf[300:600]):
        with pytest.raises(ValueError, match="overlaps"):
            fabric_step.fabric_sweep(buf[:301], src, sel, out=view)
    fabric_step.fabric_sweep(buf[:301], src, sel, out=buf[301:601])
    assert torch.equal(buf[301:601], fabric_step.fabric_sweep(buf[:301],
                                                              src, sel))


FUSED_SIZES = [(5000, 5, 0xFFFF, 1), (20000, 3, -1, 2),
               (40000, 3, 0xFFFF, 4), (60000, 5, 0xFFFF, 8),
               (60000, 40, -1, 8), (120000, 3, -1, 16),
               (120000, 40, 0xFFFF, 16), (250000, 3, -1, 0)]


def check_fused(device, kernel, case, cluster, word):
    """One call of the fused ``kernel`` on ``case`` at ``device``,
    bit-identical to its plain version, one launch, in the variant
    ``cluster`` (its ``emu.fused`` span says so); where the lanes
    outnumber the clusters the card holds at once, the rest queue.
    Returns the room a block had."""
    from repro_torch import obs

    args = BATCH_ARGS if kernel == "fabric_fused_batch" else RUN_ARGS
    kw = {} if kernel == "fabric_fused_batch" else {
        k: case[k] for k in RUN_KW}
    t = dict(zip(args, _t(case, args, device)))
    plan = fabric_step.fused_plan(kernel, t["src"], t["pe_res_idx"],
                                  t["pe_in"])
    assert plan[0] == cluster
    b = case["depths"].shape[0]
    if cluster and b >= 20:
        assert cluster_plan.active_clusters(
            kernel, t["src"].shape[0], cluster, plan[1],
            fabric_step.pe_outputs(t["pe_in"]) == 3) < b
    plain = getattr(fabric_step, kernel + "_plain")
    want = plain(*t.values(), **kw, max_depth=7, word=word)
    before = build.LAUNCHES[kernel]
    since = time.perf_counter()
    got = getattr(fabric_step, kernel)(*t.values(), **kw, max_depth=7,
                                       word=word)
    torch.cuda.synchronize()
    assert build.LAUNCHES[kernel] == before + 1
    assert torch.equal(got, want)
    spans = obs.spans("emu.fused", since)
    assert [(s.attrs["cluster"], s.attrs["room"]) for s in spans] == [plan]
    return plan[1]


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaKernels:
    """Each CUDA kernel against its plain version, on the card."""

    @pytest.mark.parametrize("seed,b,word", [(0, 5, 0xFFFF), (1, 9, -1)])
    def test_fused_batch(self, cuda, seed, b, word):
        case = fabric_case(seed, b=b, n=5000, f=20, p=200)
        want = fabric_step.fabric_fused_batch_plain(
            *_t(case, BATCH_ARGS, cuda), max_depth=7, word=word)
        before = build.LAUNCHES["fabric_fused_batch"]
        got = fabric_step.fabric_fused_batch(*_t(case, BATCH_ARGS, cuda),
                                             max_depth=7, word=word)
        torch.cuda.synchronize()
        assert build.LAUNCHES["fabric_fused_batch"] == before + 1
        assert torch.equal(got, want)

    @pytest.mark.parametrize("seed,b,t_len", [(2, 5, 6), (3, 3, 1)])
    def test_fused_run(self, cuda, seed, b, t_len):
        case = fabric_case(seed, b=b, n=5000, f=20, p=200, t_len=t_len)
        kw = {k: case[k] for k in RUN_KW}
        want = fabric_step.fabric_fused_run_plain(
            *_t(case, RUN_ARGS, cuda), **kw, max_depth=7, word=-1)
        got = fabric_step.fabric_fused_run(*_t(case, RUN_ARGS, cuda), **kw,
                                           max_depth=7, word=-1)
        torch.cuda.synchronize()
        assert torch.equal(got, want)

    @pytest.mark.parametrize("n,b,word,cluster", FUSED_SIZES)
    def test_fused_batch_variants(self, cuda, n, b, word, cluster):
        """Bit-identical to the plain version in both variants, with lane
        depths of 0, 1, ``max_depth`` and beyond it."""
        case = fabric_case(20 + b, b=b, n=n, f=20, p=200)
        case["depths"] = mixed_depths(b, 7)
        check_fused(cuda, "fabric_fused_batch", case, cluster, word)

    @pytest.mark.parametrize("n,b,word,cluster,t_len", [
        (5000, 5, -1, 1, 6), (40000, 3, 0xFFFF, 4, 4),
        (60000, 5, 0xFFFF, 8, 6), (60000, 40, -1, 8, 3),
        (60000, 3, -1, 8, 1), (120000, 3, 0xFFFF, 16, 4),
        (120000, 40, -1, 16, 1), (250000, 3, 0xFFFF, 0, 4),
        (250000, 2, -1, 0, 1)])
    def test_fused_run_variants(self, cuda, n, b, word, cluster, t_len):
        """T cycles in one launch, bit-identical to the plain version in
        both variants (T 1 included), with mixed lane depths."""
        case = fabric_case(30 + b, b=b, n=n, f=20, p=200, t_len=t_len)
        case["depths"] = mixed_depths(b, 7, seed=1)
        check_fused(cuda, "fabric_fused_run", case, cluster, word)

    @pytest.mark.parametrize("kernel", ["fabric_fused_batch",
                                        "fabric_fused_run"])
    def test_fused_kernels_at_the_tightest_room(self, cuda, kernel):
        """Every block of a 16-block lane holds exactly its counted room
        of PE records, in exactly a block's 227 KB of shared memory."""
        case = tight_case(40, 20, TIGHT["n"], TIGHT["r"], t_len=2)
        case["depths"] = mixed_depths(20, 7, seed=2)
        assert check_fused(cuda, kernel, case, 16, -1) == TIGHT["r"]

    @pytest.mark.parametrize("b,n", [(1, 1024), (8, 1000), (32, 257),
                                     (32, 1024), (33, 1000), (64, 129),
                                     (1, 1)])
    def test_minplus(self, cuda, b, n):
        d, w = minplus_case(b, b, n)
        d_t, w_t = torch.as_tensor(d, device=cuda), torch.as_tensor(
            w, device=cuda)
        assert torch.equal(minplus.minplus_step(d_t, w_t),
                           minplus.minplus_step_plain(d_t, w_t))

    def test_net_bboxes(self, cuda):
        pins, mask = bbox_case(5, 3000, 33)
        p_t = torch.as_tensor(pins, device=cuda)
        m_t = torch.as_tensor(mask, device=cuda)
        assert torch.equal(hpwl.net_bboxes(p_t, m_t),
                           hpwl.net_bboxes_plain(p_t, m_t))

    @pytest.mark.parametrize("with_out", [False, True])
    @pytest.mark.parametrize("f", [1, 2, 20, 500])
    @pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 86288])
    def test_fabric_sweep(self, cuda, n, f, with_out):
        """Bit-identical to the plain version at every N % 4 tail, F 1 to
        500 and the Amber FULL size, into a new tensor or ``out``."""
        vals, src, sel = sweep_case(n + f, 1, n, f)
        v, s, e = (torch.as_tensor(a, device=cuda)
                   for a in (vals[0], src, sel[0]))
        out = torch.full((n,), -7, dtype=torch.int32, device=cuda) \
            if with_out else None
        before = build.LAUNCHES["fabric_sweep"]
        got = fabric_step.fabric_sweep(v, s, e, out=out)
        torch.cuda.synchronize()
        assert build.LAUNCHES["fabric_sweep"] == before + 1
        assert out is None or got is out
        assert torch.equal(got, fabric_step.fabric_sweep_plain(v, s, e))

    @pytest.mark.parametrize("n", [5, 1023, 86288])
    def test_fabric_sweep_unaligned(self, cuda, n):
        """sel and out one word into larger tensors (4-B but not 16-B
        aligned) take the scalar path; src and vals unaligned too."""
        vals, src, sel = sweep_case(n, 1, n, 20)
        v, s, e = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:]
                   .view(t.shape) for t in (torch.as_tensor(a, device=cuda)
                                            for a in (vals[0], src, sel[0])))
        out = torch.zeros(n + 1, dtype=torch.int32, device=cuda)[1:]
        assert all(t.data_ptr() % 16 for t in (v, s, e, out))
        got = fabric_step.fabric_sweep(v, s, e, out=out)
        torch.cuda.synchronize()
        assert torch.equal(got, fabric_step.fabric_sweep_plain(v, s, e))

    @pytest.mark.parametrize("seed,b,n,f,kind", [
        (3, 5, 5000, 20, "random"), (4, 1, 1, 1, "random"),
        (5, 70000, 3, 2, "random"), (6, 9, 86288, 20, "random"),
        (7, 1, 86288, 20, "random"), (8, 8, 86288, 20, "random"),
        (9, 1001, 5000, 20, "random"),     # B not a multiple of BB 16
        (10, 40, 5001, 20, "random"),      # N not a multiple of the tile
        (11, 33, 3000, 1, "random"),       # F 1
        (12, 16, 3000, 20, "last"),        # every select at F - 1
        (13, 16, 3000, 20, "sentinel"),    # half the picks read column N
        (14, 16, 3000, 7, "wide"),         # V > N + 1
        (15, 12, 3000, 20, "unaligned"),   # no 16-B loads
        (16, 3, 100, 500, "random"),       # F 500: a 64-node tile
        (17, 4096, 86288, 20, "random")])
    def test_fabric_sweep_batch(self, cuda, seed, b, n, f, kind):
        """Bit-identical to the plain version at the size rule's edges;
        includes a batch above the grid's 65,535 rows (the kernel strides
        over the rest)."""
        vals, src, sel = sweep_case(seed, b, n, f)
        rng = np.random.default_rng(seed)
        if kind == "last":
            sel[:] = f - 1
        elif kind == "sentinel":
            src[:, -1] = n
            sel[rng.random(sel.shape) < 0.5] = f - 1
        elif kind == "wide":
            extra = 300
            vals = np.concatenate(
                [vals, _edge_ints(rng, (b, extra))], axis=1)
            src = rng.integers(0, n + 1 + extra, (n, f)).astype(np.int32)
        v, s, e = (torch.as_tensor(a, device=cuda) for a in (vals, src, sel))
        if kind == "unaligned":
            # views one word into larger tensors: 4-B but not 16-B aligned
            v, s, e = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:]
                       .view(t.shape) for t in (v, s, e))
            assert all(t.data_ptr() % 16 for t in (v, s, e))
        before = build.LAUNCHES["fabric_sweep_batch"]
        got = fabric_step.fabric_sweep_batch(v, s, e)
        torch.cuda.synchronize()
        assert build.LAUNCHES["fabric_sweep_batch"] == before + 1
        assert torch.equal(got,
                           fabric_step.fabric_sweep_batch_plain(v, s, e))

    @pytest.mark.parametrize("seed,n,k,wide", [(5, 3000, 33, False),
                                               (1, 1, 1, False),
                                               (3, 257, 5, True)])
    def test_hpwl(self, cuda, seed, n, k, wide):
        pins, mask = bbox_case(seed, n, k)
        if wide:
            pins = _edge_ints(np.random.default_rng(seed), pins.shape)
        p_t = torch.as_tensor(pins, device=cuda)
        m_t = torch.as_tensor(mask, device=cuda)
        before = build.LAUNCHES["hpwl"]
        got = hpwl.hpwl(p_t, m_t)
        torch.cuda.synchronize()
        assert build.LAUNCHES["hpwl"] == before + 1
        assert torch.equal(got, hpwl.hpwl_plain(p_t, m_t))

    @pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 17, 32, 33, 64])
    @pytest.mark.parametrize("n", [0, 1, 15, 3001])
    def test_boxes_every_group_size(self, cuda, n, k):
        """Both kernels bit for bit against their plain versions at every
        group size (K up to a warp, and past it), with empty nets, masked
        pins at +/- 2^21 and live pins beyond the sentinel; n 0 launches
        nothing."""
        pins, mask = wide_box_case(n * 97 + k, n, k)
        p_t = torch.as_tensor(pins, device=cuda)
        m_t = torch.as_tensor(mask, device=cuda)
        for name, fn, plain in (("net_bboxes", hpwl.net_bboxes,
                                 hpwl.net_bboxes_plain),
                                ("hpwl", hpwl.hpwl, hpwl.hpwl_plain)):
            before = build.LAUNCHES[name]
            got = fn(p_t, m_t)
            torch.cuda.synchronize()
            assert build.LAUNCHES[name] == before + (1 if n else 0)
            assert torch.equal(got, plain(p_t, m_t)), name

    @pytest.mark.parametrize("aligned", [True, False])
    def test_boxes_design_shape(self, cuda, aligned):
        """1,048,576 nets at K 4 (the reference's batched evaluation), and
        int32-wrapping HPWL; pins one word into a larger tensor take the
        two-load path."""
        pins, mask = design_box_case()
        p_t = torch.as_tensor(pins, device=cuda)
        if not aligned:
            p_t = torch.cat([p_t.new_zeros(1), p_t.reshape(-1)])[1:].view(
                p_t.shape)
            assert p_t.data_ptr() % 8
        m_t = torch.as_tensor(mask, device=cuda)
        assert torch.equal(hpwl.net_bboxes(p_t, m_t),
                           hpwl.net_bboxes_plain(p_t, m_t))
        assert torch.equal(hpwl.hpwl(p_t, m_t), hpwl.hpwl_plain(p_t, m_t))
        wide = torch.as_tensor(_edge_ints(np.random.default_rng(1),
                                          pins.shape), device=cuda)
        assert torch.equal(hpwl.hpwl(wide, m_t), hpwl.hpwl_plain(wide, m_t))

    def test_cuda_tensor_never_takes_plain_path(self, cuda):
        """A CUDA tensor the kernel does not take raises; it is never
        handed to the plain version."""
        pins, mask = bbox_case(6, 10, 4)
        with pytest.raises(TypeError):
            hpwl.net_bboxes(torch.as_tensor(pins, device=cuda).long(),
                            torch.as_tensor(mask, device=cuda))

    @pytest.mark.parametrize("b,hq,hkv,sq,skv,d,dtype,causal", [
        (2, 32, 4, 2048, 2048, 64, "bfloat16", True),    # the LM path
        (2, 4, 4, 128, 128, 64, "float32", True),
        (2, 8, 1, 256, 256, 128, "bfloat16", True),
        (2, 2, 2, 130, 384, 64, "float32", True),
        (1, 3, 3, 70, 150, 128, "float32", False),
        (1, 2, 1, 1, 1, 64, "float32", True),
        # bf16 runs the tensor-core kernel: 128-row query tiles, 128-key
        # (D 64) or 64-key (D 128) tiles; these reach its edges
        (1, 4, 2, 130, 130, 64, "bfloat16", True),
        (2, 4, 4, 70, 70, 64, "bfloat16", True),
        (1, 4, 2, 130, 384, 64, "bfloat16", True),
        (1, 2, 2, 300, 100, 64, "bfloat16", True),
        (2, 4, 2, 200, 333, 64, "bfloat16", False),
        (1, 3, 3, 70, 150, 128, "bfloat16", False),
        (1, 4, 4, 256, 256, 128, "bfloat16", True),
        (1, 8, 2, 300, 300, 128, "bfloat16", True),
        (1, 16, 2, 190, 190, 128, "bfloat16", True),
        (1, 2, 1, 1, 1, 64, "bfloat16", True),
        (1, 2, 2, 1, 1, 128, "bfloat16", True),
        # head dims 96 (Phi-3) and 112 (Kimi K2): the tile width of 128
        # with the columns past D read as zeros, on both kernels
        (1, 4, 2, 130, 130, 96, "bfloat16", True),
        (2, 4, 4, 200, 333, 96, "bfloat16", False),
        (1, 8, 1, 300, 300, 112, "bfloat16", True),
        (1, 3, 3, 70, 150, 112, "bfloat16", False),
        (1, 2, 1, 1, 1, 112, "bfloat16", True),
        (2, 2, 2, 130, 384, 96, "float32", True),
        (1, 4, 2, 190, 190, 112, "float32", True),
        (1, 3, 3, 70, 150, 112, "float32", False),
        # every other head dim (``flash_attention.plan``): the tile of 64
        # (D 16, the smoke configs'; D 8, DeepSeek-Coder's smoke; D 1 and
        # 20, copied to a padded width of 8 and 24), of 128 (D 100, padded
        # to 104) and of 256 (D 256, RecurrentGemma's; D 129 and 200)
        (2, 4, 2, 40, 40, 16, "bfloat16", True),
        (1, 4, 4, 200, 333, 16, "bfloat16", False),
        (2, 8, 2, 130, 130, 8, "bfloat16", True),
        (1, 2, 1, 70, 70, 1, "bfloat16", True),
        (1, 4, 2, 150, 150, 20, "bfloat16", True),
        (1, 4, 2, 150, 150, 100, "bfloat16", True),
        (1, 4, 2, 190, 190, 256, "bfloat16", True),
        (1, 2, 2, 130, 300, 256, "bfloat16", False),
        (1, 2, 1, 1, 1, 256, "bfloat16", True),
        (1, 2, 1, 140, 140, 129, "bfloat16", True),
        (1, 2, 2, 100, 100, 200, "bfloat16", True),
        (2, 4, 2, 40, 40, 16, "float32", True),
        (1, 3, 1, 70, 150, 1, "float32", False),
        (1, 2, 2, 130, 130, 256, "float32", True),
        (1, 2, 1, 100, 100, 200, "float32", True),
        # float16 on the tensor-core kernel instantiated for __half
        (2, 32, 4, 2048, 2048, 64, "float16", True),
        (1, 4, 2, 130, 130, 128, "float16", True),
        (1, 3, 3, 70, 150, 96, "float16", False),
        (2, 4, 2, 40, 40, 16, "float16", True),
        (1, 4, 2, 190, 190, 256, "float16", True),
        (1, 2, 1, 70, 70, 20, "float16", True),
        # batch x heads past 65,535 (the old grid's y limit)
        (1100, 64, 8, 3, 3, 16, "bfloat16", True),
        (1100, 64, 8, 3, 3, 16, "float32", True),
        (1100, 64, 8, 3, 3, 16, "float16", False),
    ])
    def test_flash_attention(self, cuda, b, hq, hkv, sq, skv, d, dtype,
                             causal):
        """Within 2e-5 of the plain version in f32 (summation order) and,
        in bf16 and f16, within one ulp of each output (rtol 2**-7 and
        2**-10) plus 1e-4: both round an f32 result to 16 bits once."""
        tdt = getattr(torch, dtype)
        q, k, v = (torch.as_tensor(a, device=cuda).to(tdt)
                   for a in attention_case(sq, skv, hq, hkv, d=d, b=b))
        before = build.LAUNCHES["flash_attention"]
        got = flash_attention.flash_attention_gqa(q, k, v, causal)
        torch.cuda.synchronize()
        assert build.LAUNCHES["flash_attention"] == before + 1
        want = flash_attention.flash_attention_gqa_plain(q, k, v, causal)
        atol, rtol = {"bfloat16": (1e-4, 2.0 ** -7),
                      "float16": (1e-4, 2.0 ** -10),
                      "float32": (2e-5, 2e-5)}[dtype]
        assert got.shape == want.shape and got.is_contiguous()
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)

    @pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
    def test_flash_attention_unaligned_views(self, cuda, dtype):
        """q, k and v that start off 16 bytes (views one element in) are
        copied to aligned buffers, not refused."""
        tdt = getattr(torch, dtype)
        q, k, v = (torch.as_tensor(a, device=cuda).to(tdt).reshape(-1)
                   for a in attention_case(70, 70, 4, 2, d=64, b=1))
        q, k, v = ((torch.cat([t[:1], t])[1:]).view(1, -1, 70, 64)
                   for t in (q, k, v))
        assert q.data_ptr() % 16
        got = flash_attention.flash_attention_gqa(q, k, v, True)
        want = flash_attention.flash_attention_gqa_plain(q, k, v, True)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=2.0 ** -7 if dtype == "bfloat16"
                                   else 2.0 ** -10)

    @pytest.mark.parametrize("bh,l,chunk", [(128, 2048, 128), (3, 300, 128),
                                            (5, 100, 128), (2, 1, 128),
                                            (64, 2048, 128), (1, 2048, 128),
                                            (2, 4096, 128), (3, 129, 128)])
    def test_ssd_scan(self, cuda, bh, l, chunk):
        """Within 1e-4 of the plain version (f32 both, no TF32; the sums
        run in another order), padded L included."""
        torch.backends.cuda.matmul.allow_tf32 = False
        args = [torch.as_tensor(a, device=cuda)
                for a in ssd_case(bh, l, 64, 128, seed=l)]
        before = build.LAUNCHES["ssd_scan"]
        got = ssd_scan.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert build.LAUNCHES["ssd_scan"] == before + 1
        want = ssd_scan.ssd_scan_plain(*args, chunk=chunk)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("bh,l,chunk,p,n", [
        (8, 64, 32, 16, 16),      # the Mamba2 smoke config's shape
        (8, 1, 32, 16, 16),
        (3, 100, 32, 16, 16),
        (64, 2048, 32, 16, 16),
        (4, 200, 32, 8, 4),       # P and N padded to (16, 16)
        (4, 200, 64, 16, 16),     # chunk 64 on the chunk-32 kernel
        (3, 300, 128, 32, 100),   # padded to (64, 128)
        (2, 300, 128, 17, 16),
        (2, 300, 128, 64, 256),   # N in two blocks, summed
        (2, 260, 128, 130, 16),   # P in three blocks
    ])
    def test_ssd_scan_every_shape(self, cuda, bh, l, chunk, p, n):
        """Every (chunk, P, N) through ``ssd_scan.plan``: within 1e-4 of
        the plain version at the asked chunk (f32 both, no TF32; another
        chunk and summation order change only the rounding); one launch
        counted a block of the plan."""
        torch.backends.cuda.matmul.allow_tf32 = False
        args = [torch.as_tensor(a, device=cuda)
                for a in ssd_case(bh, l, p, n, seed=l + p + n)]
        how = ssd_scan.plan(chunk, p, n)
        before = build.LAUNCHES["ssd_scan"]
        got = ssd_scan.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert build.LAUNCHES["ssd_scan"] == (before + how.p_blocks
                                              * how.n_blocks)
        assert got.shape == (bh, l, p) and got.is_contiguous()
        want = ssd_scan.ssd_scan_plain(*args, chunk=chunk)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

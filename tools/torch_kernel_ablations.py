#!/usr/bin/env python3
"""Time variants of hand-written CUDA kernels of the port beside the
committed ones, on one CUDA card.

    python3 tools/torch_kernel_ablations.py \
        [--only flash,minplus,fused,sweep,sweep_batch,ssd,ssd_layers,boxes]

Each variant is the committed source (``src/repro_torch/kernels/csrc/``)
with one change made by text substitution. Every variant is compiled by
its own ``nvcc`` process (all started together) into a library under
``build/ablations/`` and timed by CUDA graph (``chip_smoke.graph_ms``):

- ``flash_attention`` at the LM path's shape (B 2, Hq 32, Hkv 4, S 2,048,
  D 64, bf16, causal; the committed kernel also non-causal), beside
  PyTorch's ``scaled_dot_product_attention``;
- ``minplus_step`` at the router's FULL shape (N 1,024) for B 1, 8, 32;
- ``fabric_fused_batch`` and ``fabric_fused_run`` at ``cgra_amber.FULL``
  (B 5, N 86,288, T 16; ``chip_smoke.fused_workload``). Launch arguments
  of the committed library: its cluster kernel (8 blocks a lane, nodes in
  ``cluster_plan.order``), the same in IR node order (identity tables), its
  global-memory variant (cooperative, ``grid.sync()``) and a cluster of
  16 blocks (where the card schedules 16). Variants: the node
  descriptors and PE records resolved again every sweep from the global
  tables (the dependent-load chain), each thread's descriptors (16 slots)
  held in registers across the sweeps with all its loads in flight at once
  instead of read from shared memory four slots at a time, 1 or 8 slots
  at a time, every read through the cluster's distributed shared memory
  (no local path), the PE ALU as a switch, 512 threads a block instead
  of 1,024, the sweep's barrier built from mbarriers; and, computing
  another result on purpose, no node update (PE outputs and barriers),
  no PE evaluation, the barriers alone, every read taken from the
  reading block, and the barrier without its memory ordering;
- ``fabric_sweep`` at ``cgra_amber.FULL`` (N 86,288, F 20) on the
  pointwise app's selects and on random ones: the committed kernel (four
  nodes a thread) at its size rule's grid (one wave over every SM) and at
  ceil(N / 1,024) blocks of 256 threads or blocks of 64; the kernel as
  first ported (one node a thread); 1, 2 and 8 nodes a thread. Then the
  path around it, on the deepest of the five routed FULL apps over 16
  cycles: ``FabricModule.run`` (a CUDA graph of one sweep, replayed),
  the same sweeps run eagerly, and a CUDA graph of a whole cycle,
  captured once after an eager first cycle (its capture timed apart),
  each twice, in turns, and held to ``run``'s observations; and the
  device time of one sweep of ``run`` by itself;
- ``fabric_sweep_batch`` at verify's chunk (B 2,048, N 86,288, F 20) on
  its selects and on random ones: the committed kernel with the size
  rule's launch and with other tiles (TN), configuration lanes a block
  and groups (BB, 1 included), and with src read from device memory
  instead of the staged tile; the kernel as first ported
  (one thread per (b, i)); src transposed to (F, N) instead of the tile;
  the value gather through a plain ``ld.global``;
- ``ssd_scan`` at Mamba2-1.3B's shape (L 2,048, P 64, N 128, chunk 128)
  for BH 128 and 64: the committed kernel; the kernel as first ported
  (one block per batch*head); pass 3 over the full square of scores;
  rings of three stages instead of two; pass 3's state-dim loop unrolled
  in full; stages of 8 state dims instead of 16; and, computing another
  result on purpose, pass 3 without its scores, its c h_k^T term or its
  w x term or its stage loads (c, b, h_k), passes 1 and 3 without the
  barrier before each stage's arithmetic, and each pass alone;
- ``ssd_layers``: Mamba2-1.3B's ``lm_score`` forward as ``chip_smoke.py``
  runs it (FULL config, random weights from its seed, B 2, S 2,048).
  Each of the 48 layers' ``ssd_scan`` inputs, as the layer gives them,
  goes through the committed kernel, the kernel as first ported and the
  plain version, each held to the float64 recurrence ``ref.ssd_ref``
  (largest, mean and root-mean-square error; the kernels also against
  the plain version and its 1e-4 gate). The forward's logits with each
  in place of ``ssd_scan``, and with the float64 recurrence in place,
  are compared with the plain path's (``chip_smoke.logit_gap``).

- ``boxes``: ``net_bboxes`` and ``hpwl`` on random pin tables from the
  path's shapes (15 nets at K 2, 12 at K 3) through 4,096 and 65,536 to
  the reference's batched design shape (1,048,576 nets at K 4): the
  committed kernels at the size rule's launch (``hpwl.box_tiles``), in
  blocks of one warp, and with a warp a net (G 32); the kernels as first
  ported, at their own launch, and as the committed source's one-pass
  path; liveness by one vote of the warp instead of shuffles; the unrolled
  grid stride even where one pass covers the nets; 64-bit indices
  throughout.

The earlier kernels that variants time are kept, unchanged, in
``tools/ablation_kernels/``.

Each result carries its error against the plain version; a variant marked
``changes_result`` computes another function on purpose (it shows what a
part of the kernel costs). Prints the card's name and power limit, then
one JSON line. Needs nvcc and a card.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import (LM_BATCH, LM_SEQ, SSD_TOL, T,  # noqa: E402
                        card_line, fused_workload, graph_ms, lm_model,
                        lm_tokens, logit_gap, main_path, swapped)
from repro_torch.kernels import build, cluster_plan  # noqa: E402
from repro_torch.kernels import fabric_step as fs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import minplus as mp  # noqa: E402

OUT = os.path.join(ROOT, "build", "ablations")


def sub(old, new):
    """A variant: ``old`` (which must occur) replaced by ``new``."""
    def apply(src):
        if old not in src:
            raise ValueError(f"variant text not found: {old[:60]!r}")
        return src.replace(old, new)
    return apply


def chain(*fns):
    def apply(src):
        for fn in fns:
            src = fn(src)
        return src
    return apply


def min_by_compare(src):
    """fminf replaced by the compare-and-select it was before."""
    src = sub("namespace {\n", "namespace {\n\n__device__ __forceinline__ "
              "float min_cs(float a, float b) { return b < a ? b : a; }\n")(
                  src)
    return re.sub(r"\bfminf\(", "min_cs(", src)


EX2_FMA = """
// 2^x on the FMA pipe: x rounded by the 1.5 * 2^23 trick, a degree-5 fit
// of 2^f on [-0.5, 0.5] (relative error 2^-22), the exponent added in
__device__ __forceinline__ float ex2_fma(float x) {
    x = fmaxf(x, -126.f);
    const float j = x + 12582912.f;
    const float f = x - (j - 12582912.f);
    float p = 1.3266970636323094e-3f;
    p = fmaf(p, f, 9.675459936261177e-3f);
    p = fmaf(p, f, 5.550742521882057e-2f);
    p = fmaf(p, f, 2.4022121727466583e-1f);
    p = fmaf(p, f, 6.931469440460205e-1f);
    p = fmaf(p, f, 1.0000001192092896f);
    return __int_as_float(__float_as_int(p) + (__float_as_int(j) << 23));
}
"""


def soft_exp(cond):
    """ex2 on the FMA pipe for the scores whose (j, e) meet ``cond``."""
    return chain(
        sub("// named barriers 1 and 2:",
            EX2_FMA + "\n// named barriers 1 and 2:"),
        sub("                x = ex2(fmaf(x, c, neg));",
            f"                x = ({cond}) ? ex2_fma(fmaf(x, c, neg))\n"
            "                             : ex2(fmaf(x, c, neg));"))


SWITCH_ALU = """
// The PE ALU as a switch (a variant: the committed one selects).
__device__ __forceinline__ int32_t pe_alu_switch(int op, int32_t a, int32_t b,
                                                 int32_t c, int32_t p0,
                                                 int32_t p1, int32_t k) {
    const uint32_t ua = (uint32_t)a, ub = (uint32_t)b;
    const int s = b < 0 ? 0 : (b > 15 ? 15 : b);
    switch (op) {
        case 0: return (int32_t)(ua + ub);
        case 1: return (int32_t)(ua - ub);
        case 2: return (int32_t)(ua * ub);
        case 3: return a & b;
        case 4: return a | b;
        case 5: return a ^ b;
        case 6: return (int32_t)(ua << s);
        case 7: return a >> s;
        case 8: return a < b ? a : b;
        case 9: return a > b ? a : b;
        case 10: {
            const uint32_t d = ua - ub;
            return (int32_t)d < 0 ? (int32_t)(0u - d) : (int32_t)d;
        }
        case 11: return (a & 1) ? b : c;
        case 12: return k;
        case 14: return (int32_t)(ua > ub);
        case 15: return (int32_t)(ua >= ub);
        case 16: return (int32_t)(ua < ub);
        case 17: return (p0 & 1) ? a : b;
        case 18: return p0 & p1 & 1;
        default: return a;
    }
}

"""

SWEEP_SMEM = """            uint32_t d[kUnroll];
            int32_t v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int k = k0 + u * (int)blockDim.x;
                d[u] = k < l.nodes ? l.desc[k] : kSpecial;
            }
"""
#: each thread's descriptors (at most 16 slots at 1,024 threads) loaded
#: into registers once a fixpoint, every slot's load in flight at once
SWEEP_REGISTERS = """            uint32_t (&d)[16] = held;
            int32_t v[16];
"""
REGISTERS_PROLOGUE = """    const int n_pe = *l.n_pe;
    uint32_t held[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
        const int k = threadIdx.x + u * (int)blockDim.x;
        held[u] = k < l.nodes ? l.desc[k] : kSpecial;
    }
"""
SLOTS_IN_REGISTERS = chain(
    sub("    const int n_pe = *l.n_pe;\n", REGISTERS_PROLOGUE),
    sub("        for (int k0 = threadIdx.x; k0 < l.nodes; k0 += step) {",
        "        for (int k0 = threadIdx.x; k0 < threadIdx.x + 1; ++k0) {"),
    sub(SWEEP_SMEM, SWEEP_REGISTERS),
    sub("for (int u = 0; u < kUnroll; ++u) v[u] = load(",
        "for (int u = 0; u < 16; ++u) v[u] = load("),
    sub("            for (int u = 0; u < kUnroll; ++u)\n"
        "                if (!(d[u] & kSpecial))",
        "            for (int u = 0; u < 16; ++u)\n"
        "                if (!(d[u] & kSpecial))"))
RESOLVE_EACH_SWEEP = """                d[u] = k < l.nodes
                    ? describe<kPred>(f, l, node_at(f, l.lo + k)) : kSpecial;"""
#: the sweep's cluster barrier, and two others in its place: one built from
#: mbarriers (a block's thread 0 arrives on every block's barrier, two
#: barriers alternating by sweep; a wait that never ends traps), and
#: barrier.cluster without its release / acquire ordering (no longer a
#: correct kernel, whatever it returns)
SWEEP_END = "        cluster.sync();\n    }\n    return sweeps & 1;"
MBAR_SYNC = r"""        __syncthreads();
        {
            const uint32_t bar = smem_addr(l.n_pe) + 8 + 8 * (tick & 1);
            if (threadIdx.x == 0) {
                const int nb = (int)cluster.num_blocks();
                for (int r = 0; r < nb; ++r) {
                    uint32_t remote;
                    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                                 : "=r"(remote) : "r"(bar), "r"(r));
                    asm volatile("mbarrier.arrive.release.cluster"
                                 ".shared::cluster.b64 _, [%0];"
                                 :: "r"(remote) : "memory");
                }
            }
            const uint32_t parity = (tick >> 1) & 1;
            uint32_t done = 0;
            long long spins = 0;
            while (!done) {
                asm volatile("{\n\t.reg .pred p;\n\t"
                             "mbarrier.try_wait.parity.acquire.cluster"
                             ".shared::cta.b64 p, [%1], %2;\n\t"
                             "selp.u32 %0, 1, 0, p;\n\t}"
                             : "=r"(done) : "r"(bar), "r"(parity)
                             : "memory");
                if (++spins > (1ll << 22)) __trap();
            }
            ++tick;
        }
    }
    return sweeps & 1;"""
MBAR_INIT = r"""    if (threadIdx.x == 0) {
        *l.n_pe = 0;
        const int nb = (int)cluster.num_blocks();
        for (int i = 0; i < 2; ++i)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                         :: "r"(smem_addr(l.n_pe) + 8 + 8 * i), "r"(nb)
                         : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }"""


def replace_all(old, new):
    def apply(src):
        if old not in src:
            raise ValueError(f"variant text not found: {old[:60]!r}")
        return src.replace(old, new)
    return apply


MBAR = chain(
    sub(SWEEP_END, MBAR_SYNC),
    sub("int fixpoint(const Fabric& f, const Lane& l, int sweeps) {",
        "int fixpoint(const Fabric& f, const Lane& l, int sweeps,\n"
        "             int& tick) {"),
    sub("    const int* res =\n        fixpoint<kPred>(f, l, lane_sweeps(f, l.b)) ?",
        "    int tick = 0;\n    const int* res =\n"
        "        fixpoint<kPred>(f, l, lane_sweeps(f, l.b), tick) ?"),
    sub("        sres = fixpoint<kPred>(f, l, sweeps) ?",
        "        sres = fixpoint<kPred>(f, l, sweeps, tick) ?"),
    sub("    uint32_t sres = l.sval0;",
        "    uint32_t sres = l.sval0;\n    int tick = 0;"),
    replace_all("    if (threadIdx.x == 0) *l.n_pe = 0;", MBAR_INIT),
    sub("* room + 16;", "* room + 32;"))
RELAXED = sub(SWEEP_END,
              '        asm volatile("barrier.cluster.arrive.relaxed.aligned;'
              '\\n\\t"\n                     "barrier.cluster.wait.aligned;"'
              ' ::: "memory");\n    }\n    return sweeps & 1;')
NO_NODE_UPDATES = sub("for (int k0 = threadIdx.x; k0 < l.nodes;",
                      "for (int k0 = threadIdx.x; k0 < 0;")
NO_PE_EVAL = sub("for (int j = threadIdx.x; j < n_pe;",
                 "for (int j = threadIdx.x; j < 0;")

REFRESH = """
// Resolve PE record j again from the global tables, in place.
template <bool kPred>
__device__ void refresh_record(const Fabric& f, const Lane& l, int j) {
    int4* rec = l.rec + Pe<kPred>::kRec * j;
    const int slot = rec->x & kSlot;
    const int node = node_at(f, l.lo + slot);
    pe_record<kPred>(f, l, __ldg(f.pe_res_idx + node), slot, rec);
}

"""

#: the kernels as first ported (tools/ablation_kernels/hpwl_first.cu), as
#: the one-pass path of the committed source
OLD_BOXES = """
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ int4 warp_box(const int* __restrict__ pins,
                                         const int* __restrict__ mask,
                                         int net, int K, int lane,
                                         int* live_out) {
    int xmin = kIntMax, xmax = kIntMin;
    int ymin = kIntMax, ymax = kIntMin;
    int live = 0;
    for (int k = lane; k < K; k += 32) {
        const size_t p = (size_t)net * K + k;
        const bool m = mask[p] > 0;
        const int x = pins[2 * p], y = pins[2 * p + 1];
        xmin = min(xmin, m ? x : kSentinel);
        xmax = max(xmax, m ? x : -kSentinel);
        ymin = min(ymin, m ? y : kSentinel);
        ymax = max(ymax, m ? y : -kSentinel);
        live |= m;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        xmin = min(xmin, __shfl_xor_sync(0xffffffffu, xmin, off));
        xmax = max(xmax, __shfl_xor_sync(0xffffffffu, xmax, off));
        ymin = min(ymin, __shfl_xor_sync(0xffffffffu, ymin, off));
        ymax = max(ymax, __shfl_xor_sync(0xffffffffu, ymax, off));
    }
    *live_out = __any_sync(0xffffffffu, live);
    return make_int4(xmin, xmax, ymin, ymax);
}

template <class Store>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
old_kernel(const int* __restrict__ pins, const int* __restrict__ mask,
           int n, int K, Store store) {
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * kWarpsPerBlock;
    for (int net = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
         net < n; net += warps) {
        int live = 0;
        const int4 b = warp_box(pins, mask, net, K, lane, &live);
        if (lane == 0) store(net, Box{b.x, b.y, b.z, b.w, live});
    }
}

"""


#: liveness by one vote of the warp instead of shuffles
LIVE_VOTE = sub(
    "        b.live |= __shfl_xor_sync(0xffffffffu, b.live, off);\n"
    "    }\n",
    "    }\n"
    "    const unsigned votes = __ballot_sync(0xffffffffu, b.live);\n"
    "    b.live = G == 32 ? votes != 0\n"
    "                     : ((votes >> ((threadIdx.x & 31) & ~(G - 1)))\n"
    "                        & ((1u << G) - 1)) != 0;\n")


def earlier(name):
    """A variant that is a kernel as an earlier change committed it
    (``tools/ablation_kernels/``), in place of the committed source."""
    def apply(_):
        with open(os.path.join(ROOT, "tools", "ablation_kernels",
                               name)) as f:
            return f.read()
    return apply


def src_from_device(row, pick):
    """fabric_sweep_batch with no staged tile: each pick read from src in
    device memory at ``pick`` (node i + j's row starting at ``row``). The
    launch still reserves the tile's shared memory, unused."""
    return chain(
        sub("    stage_tile(tile, src + (size_t)i0 * f, nodes, f, ld, q, "
            "lane * q + t,\n               lanes * q, aligned);\n"
            "    __syncthreads();\n", ""),
        sub("row[j] = (j * q + t) * ld;", f"row[j] = {row};"),
        replace_all("(vals, sel, out, tile, row,", "(vals, sel, out, src, row,"),
        sub("s[u][j] = tile[row[j] + s[u][j]];",
            f"s[u][j] = j < cnt ? __ldg(tile + {pick}) : 0;"))


#: src rows read from device memory instead of the staged tile
SRC_DEVICE = src_from_device("(i + j) * f", "row[j] + s[u][j]")
#: src transposed (F, N) (the rows launch it on the transposed table), so
#: a warp's picks are coalesced where its selects agree
SRC_TRANSPOSED = src_from_device("i + j", "row[j] + (size_t)s[u][j] * n")
#: the value gather as a plain ld.global instead of the read-only path
VALS_PLAIN_LOAD = chain(
    sub("namespace {\n", "namespace {\n\n__device__ __forceinline__ int "
        "ld_plain(const int* p) {\n    int v;\n"
        '    asm volatile("ld.global.b32 %0, [%1];" : "=r"(v) : "l"(p));\n'
        "    return v;\n}\n"),
    sub("s[u][j] = j < cnt ? __ldg(vb + s[u][j]) : 0;",
        "s[u][j] = j < cnt ? ld_plain(vb + s[u][j]) : 0;"))
#: the ssd_scan's pass-3 triangle tests at their three sites
SCORE_TRIANGLE = "                    if (i >= j)\n"
WEIGHT_TRIANGLE = "            if (i < j) continue;\n"
WX_TRIANGLE = "                if (i < jb) continue;\n"
#: one of the scan's three launches left out (the others time alone)
NO_STATE_PASS = sub("        ssd_state_kernel<C, P, N><<<",
                    "        if (false) ssd_state_kernel<C, P, N><<<")
NO_CARRY_PASS = sub("        ssd_carry_kernel<<<",
                    "        if (false) ssd_carry_kernel<<<")
NO_OUTPUT_PASS = sub("    ssd_output_kernel<C, P, N><<<",
                     "    if (false) ssd_output_kernel<C, P, N><<<")

#: name -> (source, substitution, changes_result)
VARIANTS = {
    "flash": {
        "committed": (None, False),
        "no_lo_product": (sub("            wgmma_rs_n64_tb<T>(acc[p], p_lo[kk],"
                              " db);\n", ""), True),
        "no_turns": (chain(
            sub('asm volatile("bar.sync %0, %1;\\n" :: "r"(1 + g), '
                '"n"(kConsumers)\n                 : "memory");', ""),
            sub('asm volatile("bar.arrive %0, %1;\\n" :: "r"(2 - g), '
                '"n"(kConsumers)\n                 : "memory");', "")),
            False),
        "three_stages": (sub("constexpr int kStages = 2;",
                             "constexpr int kStages = 3;"), False),
        "soft_exp_eighth": (soft_exp("j % 4 == 0 && e == 0"), False),
        "soft_exp_quarter": (soft_exp("j % 2 == 0 && e == 0"), False),
    },
    "minplus": {
        "committed": (None, False),
        "sixteen_warps": (sub("constexpr int kWarps = 32;",
                              "constexpr int kWarps = 16;"), False),
        "one_lane_group": (lambda s: re.sub(r"launch<(\d), 2>",
                                            r"launch<\1, 1>", s), False),
        "compare_select_min": (min_by_compare, False),
    },
    "fused": {
        "committed": (None, False),
        "chain": (chain(
            sub("                d[u] = k < l.nodes ? l.desc[k] : kSpecial;",
                RESOLVE_EACH_SWEEP),
            sub("// `sweeps` Jacobi sweeps from val0", REFRESH
                + "// `sweeps` Jacobi sweeps from val0"),
            sub("            const int4 h = l.rec[kRec * j];",
                "            refresh_record<kPred>(f, l, j);\n"
                "            const int4 h = l.rec[kRec * j];")), False),
        "slots_in_registers": (SLOTS_IN_REGISTERS, False),
        "unroll1": (sub("constexpr int kUnroll = 4;",
                        "constexpr int kUnroll = 1;"), False),
        "unroll8": (sub("constexpr int kUnroll = 4;",
                        "constexpr int kUnroll = 8;"), False),
        "no_local_path": (sub('"setp.ne.b32 far, %2, 0;',
                              '"setp.eq.b32 far, %2, %2;'), False),
        "mbarrier_barrier": (MBAR, False),
        "switch_alu": (chain(
            sub('#include "pe_alu.cuh"\n',
                '#include "pe_alu.cuh"\n' + SWITCH_ALU),
            sub("                pe_alu<kPred>(op, operand(h.z, h.w, sv, l.spin),",
                "                pe_alu_switch(op, operand(h.z, h.w, sv, l.spin),")),
            False),
        "threads512": (sub("constexpr int kClusterThreads = 1024;",
                           "constexpr int kClusterThreads = 512;"), False),
        "no_node_updates": (NO_NODE_UPDATES, True),
        "no_pe_eval": (NO_PE_EVAL, True),
        "barriers_only": (chain(NO_NODE_UPDATES, NO_PE_EVAL), True),
        "all_local": (sub('"setp.ne.b32 far, %2, 0;',
                          '"setp.ne.b32 far, %2, %2;'), True),
        "unordered_barrier": (RELAXED, True),
    },
    "sweep": {
        "committed": (None, False),
        "first_kernel": (earlier("fabric_sweep_first.cu"), False),
        **{f"nodes{v}": (sub("constexpr int kNodes = 4;",
                             f"constexpr int kNodes = {v};"), False)
           for v in (1, 2, 8)},
    },
    "sweep_batch": {
        "committed": (None, False),
        "first_kernel": (earlier("fabric_sweep_first.cu"), False),
        "src_device_memory": (SRC_DEVICE, False),
        "src_transposed": (SRC_TRANSPOSED, False),
        "vals_plain_load": (VALS_PLAIN_LOAD, False),
    },
    "ssd": {
        "committed": (None, False),
        "first_kernel": (earlier("ssd_scan_first.cu"), False),
        "full_square": (chain(sub(SCORE_TRIANGLE, ""),
                              sub(WEIGHT_TRIANGLE, ""),
                              sub(WX_TRIANGLE, "")), False),
        "three_stages": (sub("constexpr int kStages = 2;",
                             "constexpr int kStages = 3;"), False),
        "pass1_four_blocks": (sub("__launch_bounds__(kThreads, 3)",
                                  "__launch_bounds__(kThreads, 4)"), False),
        "unroll_nn": (sub("#pragma unroll 2\n        for (int nn = 0;",
                          "#pragma unroll\n        for (int nn = 0;"),
                      False),
        "knt8": (sub("constexpr int kNT = 16;", "constexpr int kNT = 8;"),
                 False),
        "no_scores": (sub(SCORE_TRIANGLE, "                    if (false)\n"),
                      True),
        "no_inter": (sub("            if (carried) {\n#pragma unroll\n"
                         "                for (int e = 0;",
                         "            if (false) {\n#pragma unroll\n"
                         "                for (int e = 0;"), True),
        "no_intra": (sub("for (int jb = 0; jb < CI; ++jb) {",
                         "for (int jb = 0; jb < 0; ++jb) {"), True),
        "no_stage_loads": (chain(
            sub("        for (int v = tid; v < C * kNT / 2; v += kThreads) {",
                "        for (int v = tid; v < 0; v += kThreads) {"),
            sub("            for (int v = tid; v < kNT * P / 4; "
                "v += kThreads)\n",
                "            for (int v = tid; v < 0; v += kThreads)\n")),
            True),
        "no_stage_barriers": (sub(
            "        cp_wait<kStages - 1>();\n        __syncthreads();\n",
            "        cp_wait<kStages - 1>();\n"), True),
        "pass1_only": (chain(NO_CARRY_PASS, NO_OUTPUT_PASS), True),
        "pass2_only": (chain(NO_STATE_PASS, NO_OUTPUT_PASS), True),
        "pass3_only": (chain(NO_STATE_PASS, NO_CARRY_PASS), True),
    },
    "boxes": {
        "committed": (None, False),
        "old_one_pass": (chain(
            sub("// One pass, one net a group (n small)",
                OLD_BOXES + "// One pass, one net a group (n small)"),
            sub("    if (groups >= n && narrow) {\n        if (aligned) {",
                "    if (groups >= n && narrow) {\n        old_kernel<<<"
                "(n + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * "
                "kWarpsPerBlock, 0, s>>>(pins, mask, n, K, store);\n"
                "    } else if (false) {\n        if (aligned) {")), False),
        "live_vote": (LIVE_VOTE, False),
        "unroll_always": (sub("    if (groups >= n && narrow) {",
                              "    if (false) {"), False),
        "wide_index": (sub("    const bool narrow = ",
                           "    const bool narrow = false && "), False),
        "first_kernel": (earlier("hpwl_first.cu"), False),
    },
    "ssd_layers": {
        "committed": (None, False),
        "first_kernel": (earlier("ssd_scan_first.cu"), False),
    },
}
SOURCES = {"flash": "flash_attention.cu", "minplus": "minplus.cu",
           "fused": "fabric_step.cu", "sweep": "fabric_sweep.cu",
           "sweep_batch": "fabric_sweep.cu",
           "ssd": "ssd_scan.cu", "ssd_layers": "ssd_scan.cu",
           "boxes": "hpwl.cu"}
ENTRY = {"flash": "canal_flash_attention", "minplus": "canal_minplus_step"}


def entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = build._SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def build_all(kernels):
    """Compile every variant of ``kernels`` in parallel; returns
    {(kernel, variant): ctypes function} (the library for ``fused``,
    which has two entry points, and for ``sweep``, ``sweep_batch`` and
    ``ssd``, whose earlier kernels take other arguments)."""
    os.makedirs(OUT, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for kernel in kernels:
        src = open(os.path.join(build.CSRC, SOURCES[kernel])).read()
        for name, (fn, _) in VARIANTS[kernel].items():
            path = os.path.join(OUT, f"{kernel}_{name}.cu")
            with open(path, "w") as f:
                f.write(src if fn is None else fn(src))
            lib = path[:-3] + ".so"
            procs[kernel, name] = (lib, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared",
                 path, "-o", lib], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (kernel, name), (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel}/{name}:\n{out}")
        lib = ctypes.CDLL(lib)
        fns[kernel, name] = entry(lib, ENTRY[kernel]) if kernel in ENTRY \
            else lib
    return fns


def flash_rows(fns, device):
    g = torch.Generator(device).manual_seed(5)
    b, hq, hkv, s, d = 2, 32, 4, 2048, 64
    q = torch.randn((b, hq, s, d), generator=g, device=device).bfloat16()
    k = torch.randn((b, hkv, s, d), generator=g, device=device).bfloat16()
    v = torch.randn((b, hkv, s, d), generator=g, device=device).bfloat16()
    out = torch.empty_like(q)
    rows = []
    for causal in (1, 0):
        want = fa.flash_attention_gqa_plain(q, k, v, bool(causal)).float()
        for name, (_, changes) in VARIANTS["flash"].items():
            if not causal and name != "committed":
                continue
            fn = fns["flash", name]

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b, hq, hkv, s, s, d, d, causal, 1,
                         build.stream_ptr(device))
                build.check(err, name)
            call()
            torch.cuda.synchronize()
            err = float((out.float() - want).abs().max())
            rows.append({"kernel": "flash_attention", "variant": name,
                         "causal": bool(causal), "ms": graph_ms(call, 20),
                         "max_abs_err": err, "changes_result": changes})
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows.append({"kernel": "scaled_dot_product_attention", "causal": True,
                 "ms": graph_ms(lambda: sdpa(q, k, v, is_causal=True,
                                             enable_gqa=True), 20)})
    return rows


def minplus_rows(fns, device):
    rng = np.random.default_rng(0)
    n = 1024
    w = np.where(rng.random((n, n)) < 0.08, rng.uniform(0.01, 3.0, (n, n)),
                 mp.INF).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    w = torch.as_tensor(w, device=device)
    rows = []
    for b in (1, 8, 32):
        d = np.full((b, n), mp.INF, np.float32)
        d[np.arange(b), rng.choice(n, b, replace=False)] = 0.0
        d = mp.minplus_step_plain(torch.as_tensor(d, device=device), w)
        want = mp.minplus_step_plain(d, w)
        out = torch.empty_like(d)
        for name, (_, changes) in VARIANTS["minplus"].items():
            fn = fns["minplus", name]

            def call():
                build.check(fn(d.data_ptr(), w.data_ptr(), out.data_ptr(),
                               b, n, build.stream_ptr(device)), name)
            call()
            torch.cuda.synchronize()
            rows.append({"kernel": "minplus_step", "variant": name, "B": b,
                         "N": n, "ms": graph_ms(call, 50),
                         "equal": bool(torch.equal(out, want)),
                         "changes_result": changes})
    return rows


def fused_rows(libs, device):
    """Both fused kernels at FULL, B 5, for every variant and launch
    argument; each result is held bit for bit to the plain version."""
    import canal_torch
    from repro_torch.configs.cgra_amber import FULL

    fabric = canal_torch.compile(FULL, device=device,
                                 use_kernels=True).fabric()
    bargs, rargs, rkw, depths = fused_workload(fabric, device, 5)
    b, n = bargs[1].shape
    p = bargs[11].shape[0]
    f = bargs[8].shape[1]
    t_len = rargs[1].shape[1]
    md, word = rkw["max_depth"], rkw["word"]
    want_b = fs.fabric_fused_batch_plain(*bargs, max_depth=md, word=word)
    want_r = fs.fabric_fused_run_plain(*rargs, **rkw)
    out_b = torch.empty_like(want_b)
    out_r = torch.empty_like(want_r)
    state = rkw["n_reg"] + rkw["n_io"] + rkw["n_mem"] + 1
    ir_order = {"node_of": torch.arange(n, dtype=torch.int32, device=device),
                "slot_of": torch.arange(n + 1, dtype=torch.int32,
                                        device=device)}
    launches = ([("committed", 8, "slots"), ("committed", 8, "ir"),
                 ("committed", 0, "ir"), ("committed", 16, "slots")]
                + [(name, 8, "slots") for name in VARIANTS["fused"]
                   if name != "committed"])
    # a block's record room: counted in the committed order; every PE's
    # records (the bound of any order) in IR order
    rooms = fs.fused_rooms(bargs[8], bargs[12], 2 * p)
    rows = []
    for name, cluster, placed in launches:
        room = rooms[cluster] if cluster and placed == "slots" else 2 * p
        if cluster and cluster_plan.active_clusters("fabric_fused_batch", n,
                                                    cluster, room) < 1:
            rows.append({"kernel": "fabric_fused_*", "variant": name,
                         "cluster": cluster, "scheduled": False})
            continue
        lib = libs["fused", name]
        # the tables stay referenced by ``sc`` while the calls run
        sc = fs._fused_scratch("fabric_fused_run", bargs[8], b, False,
                               cluster, room, state_words=state)
        ptr = [fs._ptr(sc, k) for k in ("buf", "picked", "pinv", "state")]
        nodes = [fs._ptr(sc if placed == "slots" else ir_order, k)
                 for k in ("node_of", "slot_of")]

        def call_b():
            build.check(entry(lib, "canal_fabric_fused_batch")(
                *[a.data_ptr() for a in (bargs[3], bargs[0], bargs[1],
                                         bargs[2], *bargs[4:])],
                *nodes, out_b.data_ptr(), ptr[0], ptr[1], b, n, f, p, 0,
                md, word, cluster, room, build.stream_ptr(device)), name)

        def call_r():
            build.check(entry(lib, "canal_fabric_fused_run")(
                *[a.data_ptr() for a in (rargs[2], rargs[0], *rargs[3:7],
                                         rargs[1], *rargs[7:])],
                *nodes, out_r.data_ptr(), *ptr, b, n, f, p, 0, t_len,
                rkw["n_reg"], rkw["n_io"], rkw["n_mem"], md, word, cluster,
                room, build.stream_ptr(device)), name)

        for kernel, call, out, want, reps in (
                ("fabric_fused_batch", call_b, out_b, want_b, 20),
                ("fabric_fused_run", call_r, out_r, want_r, 3)):
            out.fill_(-7)
            call()
            torch.cuda.synchronize()
            rows.append({"kernel": kernel, "variant": name,
                         "cluster": cluster or "global", "order": placed,
                         "room": room,
                         "ms": graph_ms(call, reps),
                         "equal": bool(torch.equal(out, want)),
                         "changes_result": VARIANTS["fused"][name][1]})
    rows.append({"kernel": "fabric_fused_*", "B": b, "N": n, "T": t_len,
                 "max_depth": md, "depths": depths.tolist()})
    return rows

def sweep_rows(libs, device):
    """``fabric_sweep`` at FULL on the pointwise app's selects and on
    random ones, every variant and grid held bit for bit to the plain
    version; then the single-configuration path on the deepest routed
    app: ``run``, the eager sweeps and a graph of a whole cycle."""
    from repro_torch.configs.cgra_amber import FULL

    fab, routed, emus, ins, _, _ = main_path(FULL, device)
    fabric = fab.fabric()
    a = fabric.arrays
    n, f = a.num_nodes, a.max_fanin
    src = fabric._dev("src", a.src, torch.int32)
    rng = np.random.default_rng(4)
    vals = torch.as_tensor(rng.integers(0, 1 << 16, n + 1).astype(np.int32),
                           device=device)
    vals[n] = 0
    pointwise = emus[list(routed).index("pointwise")]
    workloads = {
        "pointwise": fabric._selects(pointwise.config[None])[0],
        "random": torch.as_tensor(rng.integers(0, f, n).astype(np.int32),
                                  device=device)}
    new_args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    old_args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    # (variant, (blocks, threads)); None: the first kernel's own launch.
    # v nodes a thread take the rule's grid for N v / 4 groups of 4
    launches = ([("committed", fs.sweep_tiles(n)),
                 ("committed", (-(-n // 1024), 256)),
                 ("committed", (-(-n // 256), 64)),
                 ("first_kernel", None)]
                + [(f"nodes{v}", fs.sweep_tiles(4 * -(-n // v)))
                   for v in (1, 2, 8)])
    out = torch.empty(n, dtype=torch.int32, device=device)
    rows = []
    for work, sel in workloads.items():
        want = fs.fabric_sweep_plain(vals, src, sel)
        for name, grid in launches:
            fn = libs["sweep", name].canal_fabric_sweep
            fn.restype = ctypes.c_int
            fn.argtypes = old_args if grid is None else new_args
            launch = (n, f) if grid is None else (n, f, *grid, 1)

            def call():
                build.check(fn(vals.data_ptr(), src.data_ptr(),
                               sel.data_ptr(), out.data_ptr(), *launch,
                               build.stream_ptr(device)), name)
            out.fill_(-7)
            call()
            torch.cuda.synchronize()
            rows.append({"kernel": "fabric_sweep", "variant": name,
                         "selects": work, "grid": grid,
                         "rule": grid == fs.sweep_tiles(n),
                         "ms": graph_ms(call, 50),
                         "equal": bool(torch.equal(out, want)),
                         "changes_result": False})
    rows.append({"kernel": "fabric_sweep", "N": n, "F": f})
    return rows + path_rows(fabric, list(routed), emus, ins)


def box_rows(libs, device):
    """``net_bboxes`` and ``hpwl`` on random pin tables (~30% masked, every
    fifth net empty) from the path's shapes (15 nets at K 2, 12 at K 3) to
    the reference's batched design shape (1,048,576 at K 4): every variant
    at the size rule's launch, the committed kernel also in blocks of one
    warp and with a warp a net (G 32), and the kernel as first ported at
    its own launch; each held bit for bit to the plain version."""
    from repro_torch.kernels import hpwl

    new_args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    old_args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    plains = {"net_bboxes": hpwl.net_bboxes_plain, "hpwl": hpwl.hpwl_plain}
    rows = []
    for n, k in ((15, 2), (12, 3), (4096, 4), (65536, 4), (1 << 20, 4)):
        rng = np.random.default_rng(n + k)
        pins = torch.as_tensor(rng.integers(0, 32, (n, k, 2)).astype(
            np.int32), device=device)
        mask = (rng.random((n, k)) < 0.7).astype(np.int32)
        mask[::5] = 0
        mask = torch.as_tensor(mask, device=device)
        g, blocks, threads = hpwl.box_tiles(n, k)
        lanes = -(-n * 32 // 256)
        rule = (g, blocks, threads)
        # in turns, eight each at the path's shapes and three beyond: the
        # committed kernel, the one before it, the one before it as the
        # committed one-pass path, liveness by one vote, and the committed
        # kernel in blocks of one warp
        warp_blocks = (g, min(-(-n * g // 32), fs.SM_COUNT * 32), 32)
        launches = ([("committed", rule), ("first_kernel", None),
                     ("old_one_pass", rule), ("live_vote", rule),
                     ("committed", warp_blocks)] * (8 if n < 64 else 3)
                    + [("committed", (32, min(lanes, 1056), 256)),
                       ("unroll_always", rule), ("wide_index", rule)])
        for kernel, plain in plains.items():
            want = plain(pins, mask)
            out = torch.empty_like(want)
            for name, launch in launches:
                fn = getattr(libs["boxes", name], "canal_" + kernel)
                fn.restype = ctypes.c_int
                fn.argtypes = old_args if launch is None else new_args
                extra = (n, k) if launch is None else (n, k, *launch, 1)

                def call():
                    build.check(fn(pins.data_ptr(), mask.data_ptr(),
                                   out.data_ptr(), *extra,
                                   build.stream_ptr(device)), name)
                out.fill_(-7)
                call()
                torch.cuda.synchronize()
                rows.append({"kernel": kernel, "variant": name,
                             "n_nets": n, "K": k, "launch": launch,
                             "rule": launch == (g, blocks, threads),
                             "ms": graph_ms(call, 50 if n < 1 << 16 else 20),
                             "equal": bool(torch.equal(out, want)),
                             "changes_result": VARIANTS["boxes"][name][1]})
    return rows


def cycle_graph_run(fabric, emu, ext):
    """``run``'s cycles with a CUDA graph of a whole cycle (start, the
    sweeps, the clock), captured after an eager first cycle on a side
    stream and replayed T - 1 times; returns (observations, capture ms)."""
    r, io = len(fabric.arrays.reg_ids), fabric.num_io
    cyc = fabric._cycle(emu.config, emu.pe_cfg)
    out = torch.zeros((ext.shape[0], io), dtype=torch.int32,
                      device=ext.device)
    obs = torch.zeros(io, dtype=torch.int32, device=ext.device)
    stream, side = torch.cuda.current_stream(), torch.cuda.Stream()
    cyc["pins"][r:r + io].copy_(ext[0])
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        fabric._eager_cycle(cyc, emu.depth, out[0])
    stream.wait_stream(side)
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fabric._eager_cycle(cyc, emu.depth, obs)
    capture_ms = (time.perf_counter() - t0) * 1e3
    for t in range(1, ext.shape[0]):
        cyc["pins"][r:r + io].copy_(ext[t])
        graph.replay()
        out[t].copy_(obs)
    return out, capture_ms


def path_rows(fabric, names, emus, ins):
    """The deepest routed app's ``T`` cycles three ways, in turns (each
    way twice): ``run`` (the committed graph of one sweep), the eager
    sweeps and a graph of a whole cycle; host ms to the observations on
    the card, each held to ``run``'s. Then the device ms of one sweep of
    ``run``, graph-timed."""
    k = max(range(len(emus)), key=lambda i: emus[i].depth)
    emu = emus[k]
    ext = fabric._ints(emu.ext_stream(ins[k], T))
    want = fabric.run(emu.config, ext, emu.pe_cfg, emu.depth)

    def eager():
        cyc = fabric._cycle(emu.config, emu.pe_cfg)
        out = torch.zeros_like(want)
        fabric._eager_cycles(cyc, ext, emu.depth, out)
        return out, None

    ways = {"graph_of_a_sweep": lambda: (fabric.run(
                emu.config, ext, emu.pe_cfg, emu.depth), None),
            "eager": eager,
            "graph_of_a_cycle": lambda: cycle_graph_run(fabric, emu, ext)}
    rows = []
    for name in list(ways) + list(ways)[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, capture_ms = ways[name]()
        torch.cuda.synchronize()
        rows.append({"path": name, "app": names[k], "depth": emu.depth,
                     "cycles": T, "ms": (time.perf_counter() - t0) * 1e3,
                     "capture_ms": capture_ms,
                     "equal": bool(torch.equal(got, want))})
    cyc = fabric._cycle(emu.config, emu.pe_cfg)
    fabric._start_cycle(cyc, cyc["vals"][0])
    rows.append({"path": "one sweep of run", "app": names[k],
                 "device_ms": graph_ms(lambda: fabric._sweep(
                     cyc, *cyc["vals"]), 50)})
    return rows


def sweep_batch_rows(libs, device):
    """``fabric_sweep_batch`` at verify's chunk (B 2,048 of FULL's
    connection cases, N 86,288, F 20; every value row equal, as there)
    and on random selects, each result held bit for bit to the plain
    version. Launch arguments of the committed library: the size rule's,
    other tiles, lanes and groups; the variants at the rule's launch."""
    import canal_torch
    from repro_torch.configs.cgra_amber import FULL
    from repro_torch.core import verify

    fabric = canal_torch.compile(FULL, device=device,
                                 use_kernels=True).fabric()
    a = fabric.arrays
    n, f = a.num_nodes, a.max_fanin
    src = fabric._dev("src", a.src, torch.int32)
    src_t = src.t().contiguous()
    slot_ids, sels = verify.sweep_cases(fabric)
    b = min(2048, len(slot_ids))
    rng = np.random.default_rng(4)
    vals = torch.as_tensor(rng.integers(0, 1 << 16, n + 1).astype(np.int32),
                           device=device)
    vals[n] = 0
    vals_b = vals.expand(b, n + 1).contiguous()
    workloads = {
        "verify": verify.case_selects(fabric, slot_ids[:b], sels[:b]),
        "random": torch.as_tensor(rng.integers(0, f, (b, n)).astype(
            np.int32), device=device)}
    rule = fs.sweep_batch_tiles(b, n, f)
    tn, lanes, bb = rule[:3]
    new_args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    old_args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    # (variant, TN, lanes, BB); TN None: the earlier kernel
    launches = ([("committed", tn, lanes, bb)]
                + [("committed", t, ln, g) for t, ln, g in (
                    (512, 4, 16), (512, 4, 32), (256, 4, 32), (256, 4, 8),
                    (256, 1, 16), (256, 2, 16), (256, 8, 16), (128, 4, 16),
                    (tn, 1, 1))]
                + [(name, None, None, None) if name == "first_kernel"
                   else (name, tn, lanes, bb)
                   for name in VARIANTS["sweep_batch"] if name != "committed"])
    out = torch.empty((b, n), dtype=torch.int32, device=device)
    rows = []
    for work, sel in workloads.items():
        want = fs.fabric_sweep_batch_plain(vals_b, src, sel)
        for name, t_n, n_lanes, group in launches:
            fn = libs["sweep_batch", name].canal_fabric_sweep_batch
            fn.restype = ctypes.c_int
            table = src_t if name == "src_transposed" else src
            ptrs = (vals_b.data_ptr(), table.data_ptr(), sel.data_ptr(),
                    out.data_ptr())
            if t_n is None:
                fn.argtypes = old_args
                launch = (b, n, f, n + 1)
            else:
                fn.argtypes = new_args
                launch = (b, n, f, n + 1, t_n, n_lanes, group,
                          min(-(-b // group), fs.MAX_GRID_Y),
                          4 * t_n * (f | 1), 1)

            def call():
                build.check(fn(*ptrs, *launch, build.stream_ptr(device)),
                            name)
            out.fill_(-7)
            call()
            torch.cuda.synchronize()
            rows.append({"kernel": "fabric_sweep_batch", "variant": name,
                         "selects": work, "TN": t_n, "lanes": n_lanes,
                         "BB": group,
                         "rule": (t_n, n_lanes, group) == rule[:3],
                         "ms": graph_ms(call, 5),
                         "equal": bool(torch.equal(out, want)),
                         "changes_result": False})
    rows.append({"kernel": "fabric_sweep_batch", "B": b, "N": n, "F": f})
    return rows


def ssd_rows(libs, device):
    """``ssd_scan`` at Mamba2-1.3B's shape (L 2,048, P 64, N 128, chunk
    128) for BH 128 (B 2, the LM path) and BH 64 (B 1), the reference
    test's input ranges; errors against the plain version."""
    from repro_torch.kernels import ssd_scan as ssd

    new_args = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    old_args = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    rows = []
    seq, p, n, chunk = 2048, 64, 128, 128
    for bh in (128, 64):
        g = torch.Generator(device).manual_seed(6)
        x = torch.randn((bh, seq, p), generator=g, device=device)
        dt = 0.1 + 0.5 * torch.rand((bh, seq), generator=g, device=device)
        a = -0.5 - torch.rand((bh,), generator=g, device=device)
        b = 0.3 * torch.randn((bh, seq, n), generator=g, device=device)
        c = 0.3 * torch.randn((bh, seq, n), generator=g, device=device)
        want = ssd.ssd_scan_plain(x, dt, a, b, c, chunk=chunk)
        y = torch.empty_like(x)
        k = -(-seq // chunk)
        states = torch.empty((bh, k, n, p), device=device)
        decay = torch.empty((bh, k), device=device)
        for name, (_, changes) in VARIANTS["ssd"].items():
            fn = libs["ssd", name].canal_ssd_scan
            fn.restype = ctypes.c_int
            head = [t.data_ptr() for t in (x, dt, a, b, c, y)]
            if name == "first_kernel":
                fn.argtypes = old_args
                args = head + [bh, seq, p, n, chunk]
            else:
                fn.argtypes = new_args
                args = head + [states.data_ptr(), decay.data_ptr(), bh,
                               seq, p, n, chunk]

            def call():
                build.check(fn(*args, build.stream_ptr(device)), name)
            y.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            rows.append({"kernel": "ssd_scan", "variant": name, "BH": bh,
                         "ms": graph_ms(call, 10),
                         "max_abs_err": float((y - want).abs().max()),
                         "changes_result": changes})
    return rows


def ssd_scan_call(lib, first):
    """An ``ssd_scan(x, dt, a, b, c, chunk)`` launching ``lib``'s kernel
    (``first``: the kernel as first ported, which takes no scratch)."""
    fn = lib.canal_ssd_scan
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (6 if first else 8)
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])

    def call(x, dt, a, b, c, chunk=128):
        bh, l, p = x.shape
        n = b.shape[-1]
        y = torch.empty_like(x)
        ptrs = [t.data_ptr() for t in (x, dt, a, b, c, y)]
        if not first:
            k = -(-l // chunk)
            states = torch.empty((bh, k, n, p), device=x.device)
            decay = torch.empty((bh, k), device=x.device)
            ptrs += [states.data_ptr(), decay.data_ptr()]
        build.check(fn(*ptrs, bh, l, p, n, chunk,
                       build.stream_ptr(x.device)), "ssd_scan")
        return y
    return call


def ssd_layer_rows(libs, device):
    """Per layer of Mamba2-1.3B's ``lm_score`` forward: the committed
    kernel, the first kernel and the plain version on the layer's own
    inputs against the float64 recurrence; then the forward's logits with
    each of them (and the recurrence) in place of ``ssd_scan``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    def float64(x, dt, a, b, c, chunk=128):
        return ref.ssd_ref(*(t.double() for t in (x, dt, a, b, c)))

    scans = {"committed": ssd_scan_call(libs["ssd_layers", "committed"],
                                        False),
             "first_kernel": ssd_scan_call(
                 libs["ssd_layers", "first_kernel"], True),
             "plain": ssd.ssd_scan_plain}
    cfg = get_config("mamba2-1.3b")
    model, plain = lm_model(cfg, device)
    tokens = {"tokens": lm_tokens(cfg, LM_BATCH, LM_SEQ, device)}
    layers = []

    def probe(x, dt, a, b, c, chunk=128):
        want = float64(x, dt, a, b, c)
        rec = {"layer": len(layers), "max_abs_y": float(want.abs().max()),
               "dt": [float(dt.min()), float(dt.max())],
               "a": [float(a.min()), float(a.max())],
               **{f"max_abs_{k}": float(t.abs().max())
                  for k, t in (("x", x), ("b", b), ("c", c))}}
        ys = {k: fn(x, dt, a, b, c, chunk=chunk) for k, fn in scans.items()}
        for k, y in ys.items():
            d = y.double() - want
            rec[k] = {"max_abs_err": float(d.abs().max()),
                      "mean_err": float(d.mean()),
                      "rms_err": float(d.square().mean().sqrt())}
            if k != "plain":
                rec[k]["vs_plain"] = float((y - ys["plain"]).abs().max())
                rec[k]["within_gate"] = bool(torch.allclose(
                    y, ys["plain"], atol=SSD_TOL, rtol=SSD_TOL))
        layers.append(rec)
        return ys["committed"]

    logits = {}
    with torch.inference_mode():
        with swapped(ssd, "ssd_scan", probe):
            logits["committed"] = model.logits(tokens)
        for k, fn in (("first_kernel", scans["first_kernel"]),
                      ("float64", lambda *t, chunk=128: float64(*t).float())):
            with swapped(ssd, "ssd_scan", fn):
                logits[k] = model.logits(tokens)
        logits["plain"] = plain.logits(tokens)
    gaps = {k: {"vs_plain": logit_gap(logits[k], logits["plain"]),
                "vs_float64": logit_gap(logits[k], logits["float64"])}
            for k in ("committed", "first_kernel", "plain")}
    del model, plain, logits
    torch.cuda.empty_cache()
    worst = {k: max(r[k]["max_abs_err"] for r in layers) for k in scans}
    return ([{"kernel": "ssd_scan", "probe": "mamba2_layer", **r}
             for r in layers]
            + [{"kernel": "ssd_scan", "probe": "mamba2_logits",
                "layers": len(layers), "worst_layer_err": worst,
                "logit_gaps": gaps}])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only",
                        default="flash,minplus,fused,sweep,sweep_batch,"
                                "ssd,ssd_layers,boxes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ablations: CUDA is not available",
              file=sys.stderr)
        return 2
    kernels = args.only.split(",")
    device = torch.device("cuda")
    fns = build_all(kernels)
    rows = []
    if "flash" in kernels:
        rows += flash_rows(fns, device)
    if "minplus" in kernels:
        rows += minplus_rows(fns, device)
    if "fused" in kernels:
        rows += fused_rows(fns, device)
    if "sweep" in kernels:
        rows += sweep_rows(fns, device)
    if "sweep_batch" in kernels:
        rows += sweep_batch_rows(fns, device)
    if "ssd" in kernels:
        rows += ssd_rows(fns, device)
    if "ssd_layers" in kernels:
        rows += ssd_layer_rows(fns, device)
    if "boxes" in kernels:
        rows += box_rows(fns, device)
    print(card_line())
    print(json.dumps({"ablations": rows,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

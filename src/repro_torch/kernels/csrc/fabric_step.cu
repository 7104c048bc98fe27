// Fused fabric fixpoint kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels in repro/kernels/fabric_step.py:
//   canal_fabric_fused_batch  <- fabric_fused_batch (_fused_batch_kernel)
//   canal_fabric_fused_run    <- fabric_fused_run   (_fused_run_kernel)
//
// One sweep updates every node of every lane from the previous sweep's
// vector (Jacobi order; an in-place update would change values on cyclic
// configurations):
//
//   nv[i] = gather  : v[src[i, sel[i]]]          (v[N] is the zero sentinel)
//   nv[i] = hold    : v[i]                       where keep[i]
//   nv[i] = re-pin  : pin_vals[i]                where pin_mask[i]
//   nv[i] = PE ALU  : res[pe_res_idx[i]]         where pe_res_idx[i] < OP
//
// A PE has O = 2 outputs (res0 = the ALU result & word, res1 = a & word)
// read from pe_in's 4 columns (data0-3), or, on a fabric with a 1-bit
// routing layer (pred), O = 3 outputs (res_p = the ALU result & 1) read
// from 7 columns (data0-3, bit0-2); the ALU's predicate ops read bit0 and
// bit1. Both layouts are template instances (kPred), so the plain layout
// compiles to what it was before the 1-bit inputs existed.
//
// A PE output node evaluates its PE from the gathered-and-pinned values of
// the PE's input nodes, which it reads from the previous vector itself.
// Every new value is then a function of the previous vector alone, so one
// barrier per sweep suffices and no PE scratch is needed (the TPU kernel's
// "read all PE inputs before placing outputs"). Lane b runs exactly
// min(depths[b], max_depth) sweeps.
//
// Bound. chip_smoke.py bounds fabric_fused_batch by bytes (every input
// read once) and fabric_fused_run by operations (one per node update, at
// the CUDA-core rate). Neither counts that a lane's sweeps run one after
// another: what bounds both on this card is sweeps x (one barrier + one
// dependent load of the previous vector).
//
// Two variants, chosen by the wrapper's size rule (fabric_step.py,
// fused_plan, on the plan rv_sweeps.cu shares: cluster_plan.py), never on
// a failure:
//
// Cluster (a lane fits a cluster's shared memory: 16 ceil((N + 1) / C) +
// 32 R + 16 <= 227 KB, 48 R with the 1-bit inputs, with C <= 16 blocks on
// an H100, where R, the record room, is the most PE outputs any one block's
// slots hold in the wrapper's order). One thread block
// cluster per lane, launched by cluster_launch.cuh (past 8 blocks a
// non-portable size); clusters that do not
// fit the card at once queue, as no cluster waits on another. The lane's
// N + 1 node slots are split over the cluster's blocks in contiguous
// ranges of `chunk`. The wrapper's node order (node_of / slot_of) puts
// each node beside the nodes it reads, so most reads stay in the reading
// block (the IR numbers switch-box, register and register-mux nodes in
// separate runs, and contiguous ranges of IR order kept only ~54% of reads
// at home at FULL). Each block keeps in
// shared memory, for its slots, four arrays of 32-bit words (16 B a slot),
// and a table of R PE records (32 B each): 172.6 + 6.7 KB a block at the
// Amber FULL size (N 86,288, P 780, 8 blocks, R 208):
//   val[0], val[1]  the double-buffered value vector (sentinel N is 0 in
//                   both and never written),
//   pin             the pinned values (fabric_fused_run rewrites them
//                   every cycle from its state; nothing else is kept of
//                   the state),
//   desc            each node's descriptor, resolved once per launch from
//                   the global tables (pe_res_idx, pin_mask, keep, sel,
//                   src): where its value comes from, as (block rank,
//                   slot) of the vector or of `pin`, or a PE record,
//   rec             the records of the PE outputs among its slots, packed
//                   (room for R): the slot, the op, the constant and
//                   three operands (an immediate, or a resolved (rank,
//                   slot)); with the 1-bit inputs a third int4 holds the
//                   bit0 and bit1 operands and the result's mask (1 for
//                   res_p). Kept in global memory, their dependent loads
//                   took ~60% of a sweep at FULL; evaluated inside the
//                   node loop, a warp walked the PE path for one lane.
// A sweep then costs a node one shared-memory descriptor read, one read of
// the vector (ld.shared in its own block; mapa + ld.shared::cluster through
// the cluster's distributed shared memory when the descriptor flags it
// remote) and one store, with kUnroll slots' loads in flight a thread;
// between sweeps one cluster barrier (barrier.cluster), not a grid
// barrier. fabric_fused_run keeps the whole cycle loop in the cluster: pin
// from the state on a zero background, the fixpoint, observe io_out, clock
// registers and memories, load the next stimulus.
//
// Global (larger fabrics). One cooperative launch walks double-buffered
// (2, B, N+1) value matrices in device memory with grid.sync() between
// sweeps; every node update re-reads its chain of tables from L2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_launch.cuh"
#include "pe_alu.cuh"

namespace cg = cooperative_groups;

namespace {

struct Fabric {
    // shared node / PE tables
    const int* src;         // (N, F)
    const int* keep;        // (N,)
    const int* pin_mask;    // (N,)
    const int* pe_in;       // (P, K), sentinel N; K = 4, or 7 with bits
    const int* pe_res_idx;  // (N,), OP when not a PE output
    // per-lane programs
    const int* depths;      // (B,)
    const int* sel;         // (B, N)
    const int* op;          // (B, P)
    const int* cst;         // (B, P)
    const int* imm_mask;    // (B, P, 4)
    const int* imm_val;     // (B, P, 4)
    // cluster variant's node order
    const int* node_of;     // (N,) node in each slot
    const int* slot_of;     // (N + 1,) slot of each node, slot_of[N] == N
    // global variant's scratch
    int* buf;               // (2, B, N + 1) value vectors, [N] == 0
    int* picked;            // (B, N) selected source per node
    const int* pinv;        // (B, N) pinned values
    int B, N, F, P, max_depth, word;
    int room;               // PE records a block holds (cluster variant)
};

struct Stream {
    const int* ext;         // (B, T, n_io)
    const int* pin_src;     // (N,) node -> state slot
    const int* reg_src;     // (R,)
    const int* mem_in;      // (M,)
    const int* io_out;      // (n_io,)
    int* obs;               // (B, T, n_io)
    int* pinv;              // (B, N)  global variant's scratch
    int* state;             // (B, S): [regs | io | mem | 0], global variant
    int T, n_reg, n_io, n_mem;
};

// A PE's layout: columns of pe_in, outputs, and int4s of one output's
// record in the cluster variant (16 kRec B: fabric_step.py's REC_BYTES and
// PRED_REC_BYTES), without (false) or with the 1-bit inputs.
template <bool kPred>
struct Pe {
    static constexpr int kIn = kPred ? 7 : 4;
    static constexpr int kOut = kPred ? 3 : 2;
    static constexpr int kRec = kPred ? 3 : 2;
};

__device__ __forceinline__ int lane_sweeps(const Fabric& f, int b) {
    int d = f.depths[b];
    d = d < 0 ? 0 : d;
    return d < f.max_depth ? d : f.max_depth;
}

// ------------------------------------------------------ the cluster variant
constexpr int kClusterThreads = 1024;
constexpr int kUnroll = 4;                  // slots a thread loads at once
// A descriptor or operand is one 32-bit word:
constexpr uint32_t kSpecial = 0x80000000u;  // node: PE output; operand: const
constexpr uint32_t kRemote = 0x40000000u;   // in another block of the cluster
constexpr uint32_t kPin = 0x20000000u;      // read `pin`, not the vector
constexpr uint32_t kSlot = 0x00FFFFFFu;     // bits 0-23: slot in its block
constexpr int kRankShift = 24;              // bits 24-28: the block's rank
constexpr uint32_t kRankMask = 31u;

// This block's part of its lane.
struct Lane {
    int b;                  // the lane (cluster index)
    int rank;               // this block's rank in the cluster
    int lo;                 // first node slot of this block
    int nodes;              // nodes < N among its slots
    int chunk;              // slots a block
    int* val0;
    int* val1;
    int* pin;
    uint32_t* desc;
    uint32_t sval0, sval1, spin;  // shared-window addresses of the arrays
    int4* rec;              // PE records of this block's outputs (f.room)
    int* n_pe;              // their count
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool kPred>
__device__ __forceinline__ Lane make_lane(const Fabric& f, int* smem) {
    cg::cluster_group cluster = cg::this_cluster();
    const int c = (int)cluster.num_blocks();
    Lane l;
    l.b = blockIdx.x / c;
    l.chunk = (f.N + c) / c;                         // ceil((N + 1) / c)
    l.rank = (int)cluster.block_rank();
    l.lo = l.rank * l.chunk;
    const int hi = min(f.N, l.lo + l.chunk);
    l.nodes = hi > l.lo ? hi - l.lo : 0;
    l.val0 = smem;
    l.val1 = smem + l.chunk;
    l.pin = smem + 2 * l.chunk;
    l.desc = reinterpret_cast<uint32_t*>(smem + 3 * l.chunk);
    l.sval0 = smem_addr(l.val0);
    l.sval1 = smem_addr(l.val1);
    l.spin = smem_addr(l.pin);
    l.rec = reinterpret_cast<int4*>(smem + 4 * l.chunk);
    l.n_pe = smem + 4 * l.chunk + 4 * Pe<kPred>::kRec * f.room;
    return l;
}

// The node in slot `pos` (< N) and the slot of node x (0..N; N stays N).
__device__ __forceinline__ int node_at(const Fabric& f, int pos) {
    return __ldg(f.node_of + pos);
}

// Node x (0..N) as (rank, slot in that block), flagged when it lies in
// another block than this one.
__device__ __forceinline__ uint32_t locate(const Fabric& f, const Lane& l,
                                           int x) {
    const int pos = __ldg(f.slot_of + x);
    const int rank = pos / l.chunk;
    return ((uint32_t)rank << kRankShift) | (uint32_t)(pos % l.chunk) |
           (rank != l.rank ? kRemote : 0u);
}

// The operand that reads node u's value after gather, hold and re-pin
// (before PE placement); u == N (absent fan-in) is the constant 0.
__device__ uint32_t gathered_operand(const Fabric& f, const Lane& l, int u) {
    if (u >= f.N) return kSpecial;
    if (__ldg(f.pin_mask + u) > 0) return kPin | locate(f, l, u);
    if (__ldg(f.keep + u) > 0) return locate(f, l, u);
    const int s = __ldg(f.sel + (size_t)l.b * f.N + u);
    return locate(f, l, __ldg(f.src + (size_t)u * f.F + s));
}

// Node `node`'s descriptor: where its value comes from, or kSpecial for a
// PE output, which the block's PE records compute.
template <bool kPred>
__device__ __forceinline__ uint32_t describe(const Fabric& f, const Lane& l,
                                             int node) {
    if (__ldg(f.pe_res_idx + node) < Pe<kPred>::kOut * f.P) return kSpecial;
    return gathered_operand(f, l, node);
}

// The record of PE result r, placed in this block's `slot`: (slot and op
// + 1 in bits 24-31, op -1 for res1 = a & word; the PE's constant) then
// (operand, constant) for a, b and c; with the 1-bit inputs then (bit0's
// operand, bit1's operand, the result's mask: 1 for res_p, else word).
template <bool kPred>
__device__ void pe_record(const Fabric& f, const Lane& l, int r, int slot,
                          int4* rec) {
    using L = Pe<kPred>;
    const int k = r / L::kOut, col = r - k * L::kOut;
    const size_t pk = (size_t)l.b * f.P + k;
    uint32_t o[3] = {kSpecial, kSpecial, kSpecial};
    int c[3] = {0, 0, 0};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        if (j > 0 && col == 1) break;         // res1 needs input a only
        if (__ldg(f.imm_mask + pk * 4 + j) > 0)
            c[j] = __ldg(f.imm_val + pk * 4 + j);
        else
            o[j] = gathered_operand(f, l, __ldg(f.pe_in + k * L::kIn + j));
    }
    const int op = col == 1 ? -1 : __ldg(f.op + pk);
    rec[0] = make_int4(slot | ((op + 1) << kRankShift), __ldg(f.cst + pk),
                       (int)o[0], c[0]);
    rec[1] = make_int4((int)o[1], c[1], (int)o[2], c[2]);
    if (kPred) {
        uint32_t p[2] = {kSpecial, kSpecial};
        if (col != 1) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
                p[j] = gathered_operand(f, l,
                                        __ldg(f.pe_in + k * L::kIn + 4 + j));
        }
        rec[2] = make_int4((int)p[0], (int)p[1], col == 2 ? 1 : f.word, 0);
    }
}

// Slot k's descriptor; a PE output also appends its record to the block's.
// The wrapper's room is the most PE outputs any block's slots hold, so no
// record lands past it (a trap, should the tables disagree).
template <bool kPred>
__device__ __forceinline__ uint32_t prepare(const Fabric& f, const Lane& l,
                                            int node, int k) {
    const uint32_t d = describe<kPred>(f, l, node);
    if (d == kSpecial) {
        const int j = atomicAdd(l.n_pe, 1);
        if (j >= f.room) __trap();
        pe_record<kPred>(f, l, __ldg(f.pe_res_idx + node), k,
                         l.rec + Pe<kPred>::kRec * j);
    }
    return d;
}

// Read a (rank, slot) of the vector at `sval` or, with kPin, of `pin`:
// from this block's shared memory, or with kRemote through the cluster's
// distributed shared memory. Both loads are predicated in one asm block:
// a branch would keep a thread's kUnroll loads from being in flight at
// once.
__device__ __forceinline__ int32_t load(uint32_t d, uint32_t sval,
                                        uint32_t spin) {
    const uint32_t addr = ((d & kPin) ? spin : sval) + ((d & kSlot) << 2);
    int32_t v;
    asm volatile(
        "{\n\t.reg .pred far;\n\t.reg .b32 ra;\n\t"
        "setp.ne.b32 far, %2, 0;\n\t"
        "mapa.shared::cluster.u32 ra, %1, %3;\n\t"
        "@far ld.shared::cluster.u32 %0, [ra];\n\t"
        "@!far ld.shared.u32 %0, [%1];\n\t}"
        : "=r"(v)
        : "r"(addr), "r"(d & kRemote), "r"((d >> kRankShift) & kRankMask));
    return v;
}

// A PE operand: the constant c (kSpecial), else the value o locates. The
// load runs either way (kSpecial's own bits locate slot 0 of this
// block), so that no branch holds the PE's three loads apart.
__device__ __forceinline__ int32_t operand(int o, int c, uint32_t sval,
                                           uint32_t spin) {
    const int32_t v = load((uint32_t)o, sval, spin);
    return ((uint32_t)o & kSpecial) ? c : v;
}

// `sweeps` Jacobi sweeps from val0: every block reads the previous vector
// of the whole cluster and writes its own slots of the other buffer: its
// PE outputs from their records first (packed, so a warp evaluates up to
// 32 PEs at once rather than one among 31 idle lanes, while the other
// warps start on the nodes), then the other nodes; one cluster barrier a
// sweep. Returns the buffer that holds the result.
template <bool kPred>
__device__ int fixpoint(const Fabric& f, const Lane& l, int sweeps) {
    cg::cluster_group cluster = cg::this_cluster();
    const int step = kUnroll * (int)blockDim.x;
    const int n_pe = *l.n_pe;
    constexpr int kRec = Pe<kPred>::kRec;
    for (int t = 0; t < sweeps; ++t) {
        const uint32_t sv = (t & 1) ? l.sval1 : l.sval0;
        int* to = (t & 1) ? l.val0 : l.val1;
        for (int j = threadIdx.x; j < n_pe; j += blockDim.x) {
            const int4 h = l.rec[kRec * j];       // slot | op, const, a
            const int4 g = l.rec[kRec * j + 1];   // b, c
            const int op = ((uint32_t)h.x >> kRankShift) - 1;  // -1: res1
            int32_t p0 = 0, p1 = 0, mask = f.word;
            if (kPred) {                          // bit0, bit1, mask
                const int4 q = l.rec[kRec * j + 2];
                p0 = operand(q.x, 0, sv, l.spin);
                p1 = operand(q.y, 0, sv, l.spin);
                mask = q.z;
            }
            to[h.x & kSlot] =
                pe_alu<kPred>(op, operand(h.z, h.w, sv, l.spin),
                              operand(g.x, g.y, sv, l.spin),
                              operand(g.z, g.w, sv, l.spin), p0, p1, h.y) &
                mask;
        }
        for (int k0 = threadIdx.x; k0 < l.nodes; k0 += step) {
            uint32_t d[kUnroll];
            int32_t v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int k = k0 + u * (int)blockDim.x;
                d[u] = k < l.nodes ? l.desc[k] : kSpecial;
            }
            // every slot loads (a PE output's kSpecial reads slot 0 of this
            // block) and only the others store: a thread's kUnroll loads
            // are in flight at once, with no branch between
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) v[u] = load(d[u], sv, l.spin);
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
                if (!(d[u] & kSpecial)) to[k0 + u * (int)blockDim.x] = v[u];
        }
        cluster.sync();
    }
    return sweeps & 1;
}

template <bool kPred>
__global__ void __launch_bounds__(kClusterThreads, 1)
cluster_batch_kernel(Fabric f, const int* vals0, int* out) {
    extern __shared__ int smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const Lane l = make_lane<kPred>(f, smem);
    const size_t row = (size_t)l.b * f.N;
    if (threadIdx.x == 0) *l.n_pe = 0;
    __syncthreads();
#pragma unroll 4
    for (int k = threadIdx.x; k < l.chunk; k += blockDim.x) {
        const int pos = l.lo + k;
        if (pos < f.N) {
            const int node = node_at(f, pos);
            l.desc[k] = prepare<kPred>(f, l, node, k);
            l.val0[k] = vals0[row + node];
            l.pin[k] = f.pinv[row + node];
        } else if (pos == f.N) {
            l.val0[k] = 0;
            l.val1[k] = 0;
        }
    }
    cluster.sync();
    const int* res =
        fixpoint<kPred>(f, l, lane_sweeps(f, l.b)) ? l.val1 : l.val0;
    // after the last barrier only this block's own slots are read
    for (int k = threadIdx.x; k < l.nodes; k += blockDim.x)
        out[row + node_at(f, l.lo + k)] = res[k];
}

// State slot `slot` ([regs | io | mem | 0]) at the start of cycle c:
// registers and memories are zero in cycle 0 and later take the previous
// cycle's result vector (at `sres`); the io slots take cycle c's stimulus.
__device__ __forceinline__ int32_t slot_value(const Fabric& f,
                                              const Stream& s, const Lane& l,
                                              int c, int slot,
                                              uint32_t sres) {
    const int j = slot - s.n_reg, m = j - s.n_io;
    if (slot < s.n_reg)
        return c == 0 ? 0
                      : load(locate(f, l, __ldg(s.reg_src + slot)), sres, 0);
    if (j < s.n_io)
        return __ldg(s.ext + ((size_t)l.b * s.T + c) * s.n_io + j);
    if (m < s.n_mem)
        return c == 0 ? 0
                      : load(locate(f, l, __ldg(s.mem_in + m)), sres, 0);
    return 0;
}

template <bool kPred>
__global__ void __launch_bounds__(kClusterThreads, 1)
cluster_run_kernel(Fabric f, Stream s) {
    extern __shared__ int smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const Lane l = make_lane<kPred>(f, smem);
    const int first = (int)cluster.block_rank() * blockDim.x + threadIdx.x;
    const int stride = (int)cluster.num_blocks() * blockDim.x;
    if (threadIdx.x == 0) *l.n_pe = 0;
    __syncthreads();
#pragma unroll 4
    for (int k = threadIdx.x; k < l.chunk; k += blockDim.x) {
        const int pos = l.lo + k;
        if (pos < f.N) {
            l.desc[k] = prepare<kPred>(f, l, node_at(f, pos), k);
        } else if (pos == f.N) {
            l.val0[k] = 0;
            l.val1[k] = 0;
        }
    }
    const int sweeps = lane_sweeps(f, l.b);
    uint32_t sres = l.sval0;
    for (int c = 0; c < s.T; ++c) {
        // each cycle starts from the pinned sources on a zero background
        for (int k = threadIdx.x; k < l.nodes; k += blockDim.x) {
            const int node = node_at(f, l.lo + k);
            l.pin[k] = __ldg(f.pin_mask + node) > 0
                           ? slot_value(f, s, l, c, __ldg(s.pin_src + node),
                                        sres)
                           : 0;
        }
        if (c > 0) cluster.sync();        // the last vector is read out
        for (int k = threadIdx.x; k < l.nodes; k += blockDim.x)
            l.val0[k] = l.pin[k];
        cluster.sync();
        sres = fixpoint<kPred>(f, l, sweeps) ? l.sval1 : l.sval0;
        for (int j = first; j < s.n_io; j += stride)
            s.obs[((size_t)l.b * s.T + c) * s.n_io + j] =
                load(locate(f, l, __ldg(s.io_out + j)), sres, 0);
    }
    cluster.sync();      // no block leaves while another reads its slots
}

// Shared memory of one block: four words a slot, `room` PE records, the
// record count.
size_t cluster_smem(int n, int room, int pred, int cluster) {
    return (size_t)16 * (size_t)((n + cluster) / cluster) +
           (size_t)16 * (pred ? Pe<true>::kRec : Pe<false>::kRec) * room + 16;
}

// ------------------------------------------------------- the global variant
constexpr int kThreads = 256;

__device__ __forceinline__ int* lane_buf(const Fabric& f, int which, int b) {
    return f.buf + ((size_t)which * f.B + b) * (size_t)(f.N + 1);
}

// Node value after gather, hold and re-pin (before PE placement).
__device__ __forceinline__ int32_t gathered(const Fabric& f, const int* v,
                                            int b, int i) {
    if (i >= f.N) return 0;
    const size_t bi = (size_t)b * f.N + i;
    if (f.pin_mask[i] > 0) return f.pinv[bi];
    if (f.keep[i] > 0) return v[i];
    return v[f.picked[bi]];
}

template <bool kPred>
__device__ __forceinline__ int32_t node_update(const Fabric& f, const int* v,
                                               int b, int i) {
    using L = Pe<kPred>;
    const int r = f.pe_res_idx[i];
    if (r >= L::kOut * f.P) return gathered(f, v, b, i);
    const int k = r / L::kOut, col = r - k * L::kOut;
    const size_t pk = (size_t)b * f.P + k;
    int32_t ins[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        ins[j] = f.imm_mask[pk * 4 + j] > 0
                     ? f.imm_val[pk * 4 + j]
                     : gathered(f, v, b, f.pe_in[k * L::kIn + j]);
        if (col == 1) break;              // res1 = a & word needs a only
    }
    if (col == 1) return ins[0] & f.word;
    int32_t p0 = 0, p1 = 0;
    if (kPred) {
        p0 = gathered(f, v, b, f.pe_in[k * L::kIn + 4]);
        p1 = gathered(f, v, b, f.pe_in[k * L::kIn + 5]);
    }
    return pe_alu<kPred>(f.op[pk], ins[0], ins[1], ins[2], p0, p1,
                         f.cst[pk]) &
           (col == 2 ? 1 : f.word);
}

// picked[b, i] = src[i, sel[b, i]] (sweep-invariant).
__device__ void pick_sources(const Fabric& f) {
    const size_t total = (size_t)f.B * f.N;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         idx < total; idx += stride) {
        const size_t i = idx % f.N;
        f.picked[idx] = f.src[i * f.F + f.sel[idx]];
    }
}

// The fixpoint, written once for both global kernels: buffer 0 holds the
// start vector of every lane; lane b's result ends in buffer
// (sweeps(b) & 1). Threads stride over the flat (lane, node) space. A lane
// that is done still reaches every grid.sync() (a return would deadlock
// the grid); it just stops swapping buffers.
template <bool kPred>
__device__ void grid_fixpoint(cg::grid_group& grid, const Fabric& f) {
    const int total = f.B * f.N;
    const int stride = gridDim.x * blockDim.x;
    const int first = blockIdx.x * blockDim.x + threadIdx.x;
    for (int t = 0; t < f.max_depth; ++t) {
        const int from = t & 1;
        for (int idx = first; idx < total; idx += stride) {
            const int b = idx / f.N;
            const int i = idx - b * f.N;
            if (t < lane_sweeps(f, b))
                lane_buf(f, from ^ 1, b)[i] =
                    node_update<kPred>(f, lane_buf(f, from, b), b, i);
        }
        grid.sync();
    }
}

template <bool kPred>
__global__ void __launch_bounds__(kThreads)
grid_batch_kernel(Fabric f, const int* vals0, int* out) {
    cg::grid_group grid = cg::this_grid();
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t total = (size_t)f.B * (f.N + 1);
    for (size_t idx = first; idx < total; idx += stride) {
        const size_t b = idx / (f.N + 1), i = idx % (f.N + 1);
        f.buf[idx] = i < (size_t)f.N ? vals0[b * f.N + i] : 0;
        if (i == (size_t)f.N) f.buf[total + idx] = 0;
    }
    pick_sources(f);
    grid.sync();
    grid_fixpoint<kPred>(grid, f);
    for (size_t idx = first; idx < (size_t)f.B * f.N; idx += stride) {
        const int b = (int)(idx / f.N);
        const int i = (int)(idx % f.N);
        out[idx] = lane_buf(f, lane_sweeps(f, b) & 1, b)[i];
    }
}

template <bool kPred>
__global__ void __launch_bounds__(kThreads)
grid_run_kernel(Fabric f, Stream s) {
    cg::grid_group grid = cg::this_grid();
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int S = s.n_reg + s.n_io + s.n_mem + 1;
    // state starts at zero with cycle 0's stimulus in the io slots; the
    // sentinel entries of both value buffers are zero for good
    for (size_t idx = first; idx < (size_t)f.B * S; idx += stride) {
        const int b = (int)(idx / S), k = (int)(idx % S);
        const int j = k - s.n_reg;
        s.state[idx] = (j >= 0 && j < s.n_io)
                           ? s.ext[(size_t)b * s.T * s.n_io + j] : 0;
    }
    for (size_t b = first; b < (size_t)f.B; b += stride) {
        lane_buf(f, 0, (int)b)[f.N] = 0;
        lane_buf(f, 1, (int)b)[f.N] = 0;
    }
    pick_sources(f);
    grid.sync();
    for (int c = 0; c < s.T; ++c) {
        // each cycle starts from the pinned sources on a zero background
        for (size_t idx = first; idx < (size_t)f.B * f.N; idx += stride) {
            const int b = (int)(idx / f.N);
            const int i = (int)(idx % f.N);
            const int pv = f.pin_mask[i] > 0
                               ? s.state[(size_t)b * S + s.pin_src[i]] : 0;
            s.pinv[idx] = pv;
            lane_buf(f, 0, b)[i] = pv;
        }
        grid.sync();
        grid_fixpoint<kPred>(grid, f);
        // observe, then clock registers / memories and load the next
        // cycle's stimulus
        for (size_t idx = first; idx < (size_t)f.B * S; idx += stride) {
            const int b = (int)(idx / S), k = (int)(idx % S);
            const int* v = lane_buf(f, lane_sweeps(f, b) & 1, b);
            const int j = k - s.n_reg, m = k - s.n_reg - s.n_io;
            if (k < s.n_reg) {
                s.state[idx] = v[s.reg_src[k]];
            } else if (j < s.n_io) {
                s.obs[((size_t)b * s.T + c) * s.n_io + j] = v[s.io_out[j]];
                if (c + 1 < s.T)
                    s.state[idx] =
                        s.ext[((size_t)b * s.T + c + 1) * s.n_io + j];
            } else if (m < s.n_mem) {
                s.state[idx] = v[s.mem_in[m]];
            }
        }
        grid.sync();
    }
}

template <typename Kernel>
int cooperative_grid(Kernel kernel, size_t work, int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    size_t want = (work + kThreads - 1) / kThreads;
    size_t cap = (size_t)sms * (size_t)per_sm;
    *blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
    return 0;
}

Fabric make_fabric(const int* depths, const int* sel, const int* op,
                   const int* cst, const int* imm_mask, const int* imm_val,
                   const int* src, const int* keep, const int* pin_mask,
                   const int* pe_in, const int* pe_res_idx,
                   const int* node_of, const int* slot_of, int* buf,
                   int* picked, const int* pinv, int B, int N, int F, int P,
                   int max_depth, int word, int room) {
    Fabric f;
    f.node_of = node_of; f.slot_of = slot_of;
    f.src = src; f.keep = keep; f.pin_mask = pin_mask; f.pe_in = pe_in;
    f.pe_res_idx = pe_res_idx; f.depths = depths; f.sel = sel; f.op = op;
    f.cst = cst; f.imm_mask = imm_mask; f.imm_val = imm_val; f.buf = buf;
    f.picked = picked; f.pinv = pinv; f.B = B; f.N = N; f.F = F; f.P = P;
    f.max_depth = max_depth; f.word = word; f.room = room;
    return f;
}

template <bool kPred>
int fused_batch(const Fabric& f, const int* vals0, int* out, int cluster,
                cudaStream_t stream) {
    if (cluster > 0)
        return launch_cluster(cluster_batch_kernel<kPred>, f.B * cluster,
                              kClusterThreads, cluster,
                              cluster_smem(f.N, f.room, kPred, cluster),
                              stream, f, vals0, out);
    int blocks = 0;
    int err = cooperative_grid(grid_batch_kernel<kPred>,
                               (size_t)f.B * (f.N + 1), &blocks);
    if (err) return err;
    Fabric fa = f;
    void* args[] = {&fa, &vals0, &out};
    cudaLaunchCooperativeKernel((void*)grid_batch_kernel<kPred>, dim3(blocks),
                                dim3(kThreads), args, 0, stream);
    return (int)cudaGetLastError();
}

template <bool kPred>
int fused_run(const Fabric& f, const Stream& s, int cluster,
              cudaStream_t stream) {
    if (cluster > 0)
        return launch_cluster(cluster_run_kernel<kPred>, f.B * cluster,
                              kClusterThreads, cluster,
                              cluster_smem(f.N, f.room, kPred, cluster),
                              stream, f, s);
    int blocks = 0;
    int err = cooperative_grid(grid_run_kernel<kPred>,
                               (size_t)f.B * (f.N + 1), &blocks);
    if (err) return err;
    Fabric fa = f;
    Stream sa = s;
    void* args[] = {&fa, &sa};
    cudaLaunchCooperativeKernel((void*)grid_run_kernel<kPred>, dim3(blocks),
                                dim3(kThreads), args, 0, stream);
    return (int)cudaGetLastError();
}

}  // namespace

// cluster > 0: the cluster variant with `cluster` blocks a lane, nodes
// placed in slots by node_of / slot_of (no scratch), room for `room` PE
// records a block; cluster == 0: the global variant (scratch: buf, picked;
// room unused). pred: pe_in has the 1-bit inputs (7 columns) and a PE
// three outputs.
extern "C" int canal_fabric_fused_batch(
    const int* depths, const int* vals0, const int* sel, const int* pin_vals,
    const int* op, const int* cst, const int* imm_mask, const int* imm_val,
    const int* src, const int* keep, const int* pin_mask, const int* pe_in,
    const int* pe_res_idx, const int* node_of, const int* slot_of, int* out,
    int* buf, int* picked, int B, int N, int F, int P, int pred,
    int max_depth, int word, int cluster, int room, void* stream) {
    Fabric f = make_fabric(depths, sel, op, cst, imm_mask, imm_val, src, keep,
                           pin_mask, pe_in, pe_res_idx, node_of, slot_of, buf,
                           picked, pin_vals, B, N, F, P, max_depth, word,
                           room);
    return pred ? fused_batch<true>(f, vals0, out, cluster,
                                    (cudaStream_t)stream)
                : fused_batch<false>(f, vals0, out, cluster,
                                     (cudaStream_t)stream);
}

// cluster > 0: the cluster variant, nodes placed by node_of / slot_of (no
// scratch), room as in canal_fabric_fused_batch; cluster == 0: the global
// variant (scratch: buf, picked, pinv, state). pred as in
// canal_fabric_fused_batch.
extern "C" int canal_fabric_fused_run(
    const int* depths, const int* sel, const int* op, const int* cst,
    const int* imm_mask, const int* imm_val, const int* ext, const int* src,
    const int* keep, const int* pin_mask, const int* pin_src,
    const int* pe_in, const int* pe_res_idx, const int* reg_src,
    const int* mem_in, const int* io_out, const int* node_of,
    const int* slot_of, int* obs, int* buf, int* picked, int* pinv,
    int* state, int B, int N, int F, int P, int pred, int T, int n_reg,
    int n_io, int n_mem, int max_depth, int word, int cluster, int room,
    void* stream) {
    Fabric f = make_fabric(depths, sel, op, cst, imm_mask, imm_val, src, keep,
                           pin_mask, pe_in, pe_res_idx, node_of, slot_of, buf,
                           picked, pinv, B, N, F, P, max_depth, word, room);
    Stream s;
    s.ext = ext; s.pin_src = pin_src; s.reg_src = reg_src; s.mem_in = mem_in;
    s.io_out = io_out; s.obs = obs; s.pinv = pinv; s.state = state; s.T = T;
    s.n_reg = n_reg; s.n_io = n_io; s.n_mem = n_mem;
    return pred ? fused_run<true>(f, s, cluster, (cudaStream_t)stream)
                : fused_run<false>(f, s, cluster, (cudaStream_t)stream);
}

// How many clusters of `cluster` blocks of the batch (run == 0) or run
// (run == 1) kernel at N nodes and `room` PE records a block (pred: with the
// 1-bit inputs) the card holds at once (0: none).
extern "C" int canal_fabric_fused_clusters(int run, int N, int room,
                                           int cluster, int pred,
                                           int* active) {
    const size_t smem = cluster_smem(N, room, pred, cluster);
    auto query = [&](auto kernel) {
        return max_active_clusters(kernel, kClusterThreads, cluster, smem,
                                   active);
    };
    if (run)
        return pred ? query(cluster_run_kernel<true>)
                    : query(cluster_run_kernel<false>);
    return pred ? query(cluster_batch_kernel<true>)
                : query(cluster_batch_kernel<false>);
}

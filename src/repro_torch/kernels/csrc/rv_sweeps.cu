// A ready-valid cycle's sweeps for Hopper (sm_90a): canal_rv_sweeps.
//
// Replaces no Pallas kernel: the reference (repro/fabric/ready_valid.py)
// leaves its sweeps to XLA. It took the place, on the card, of CUDA-graph
// replays of RVFabric._forward_sweep / _backward_sweep (two graphs a sweep
// pair, ~50 + 3 small PyTorch kernels; 254 replays and 19.25 ms a cycle
// on the east route across cgra_amber.FULL, depth 127). One launch runs a
// cycle's `depth` forward and `depth` backward Jacobi sweeps from the
// buffers RVFabric._rv_start leaves, and writes both buffers of data,
// valid and ready as the eager sweeps leave them (the last sweep's result
// in buffer depth % 2, the one before in the other).
//
//   data, valid  nv[i] = v[picked[i]], held where undriven (keep), the
//                pinned sources (registers, driven IO) re-pinned from
//                pins_d / pins_v, PE outputs from their cores: data
//                alu(op, a, b, c, const) & word (res1: a & word), valid
//                min(v[a], v[b]) (an absent input reads 1)
//   ready        nr[i] = fix_mask[i] ? fix_val[i]
//                                    : min over i's used consumers of r
//                (1 more where i's consumer row holds an unused slot)
//
// Bound. The roofline count (canalbench/roofline.py) is 3 operations a
// connection a sweep: 1.4 us a cycle at FULL. A cycle's sweeps run one
// after another, so what bounds this kernel is depth x (one cluster
// barrier + a dependent shared-memory load), as for fabric_fused_run
// (kernel table row 4: 2.3 us a sweep). Everything a sweep touches stays
// in shared memory; nothing of it goes to device memory between sweeps.
//
// Design. The three vectors are independent within a cycle (ready reads
// only the selects, the occupancy and the sinks), so one launch holds
// three thread-block clusters of C blocks, one a vector: the critical
// path is `depth` sweeps, not 2 x depth. Within a cluster the node slots
// are split over its blocks in contiguous ranges of `chunk`, in the node
// order of cluster_plan.order (each node beside the nodes it reads,
// so most reads stay in the reading block); a read of another block goes
// through the cluster's distributed shared memory (mapa +
// ld.shared::cluster); one barrier.cluster a sweep. The per-configuration
// tables (every slot's descriptor, the PE records by block) are resolved
// once a run by kernels/rv_sweep.py:rv_tables; a launch reads them, the
// pins, fix_mask / fix_val and buffer 0.
//
//   forward  a descriptor a slot: the (rank, slot) it copies, its own slot
//            for a held node, kPin for a pinned one (buffer 1 starts with
//            its pin; sweep 0 leaves it, later sweeps hold it), kSpecial
//            for a PE output (the block's PE records write it). A PE
//            reads its inputs through each input's own descriptor from the
//            previous vector, as fabric_step.cu does, so a sweep needs one
//            barrier and no PE scratch. (A PE's inputs are its connection
//            boxes' ports, never pinned; rv_tables refuses one that is.)
//   backward a node's list of used consumers has no bound in a block
//            (fan-out). Each node is, though, the used consumer of one
//            producer at most: its picked source. So the
//            backward sweep pushes: every slot reads its own ready and
//            min-reduces it into its producer's slot of the next buffer
//            (red.shared::cluster.min.s32), one word a slot. Three
//            buffers: a sweep reads buffer t % 3, pushes into (t + 1) % 3
//            and resets (t + 2) % 3 to its start (1, or INT_MAX where
//            every consumer slot is used; a node fixed this cycle keeps
//            fix_val, and nothing pushes into it). One barrier a sweep.
//
// Shared memory a block (4 B words; chunk = ceil((N + 1) / C) rounded up
// to 4): data and valid two buffers and the descriptors (12 B a slot) and
// the PE records among the block's slots (32 B a data record, 16 B a
// valid one, room for R, the most any block holds); ready three buffers
// and the descriptors (16 B a slot). At FULL (N 86,288, C 8, chunk 10,788,
// R 208): data 129,456 + 6,656 = 136,112 B, ready 172,608 B, inside the
// 232,448 B a block may opt into. The cluster size follows the plan the
// fused kernels share (kernels/cluster_plan.py, from rv_sweep.py:rv_plan):
// the least C of 1, 2, 4, 8, 16 that fits, 16 (non-portable) only where
// the card holds one; past 16 blocks (N + 1 > 232,448) RVFabric sweeps
// eagerly.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_launch.cuh"
#include "pe_alu.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;                  // slots a thread loads at once
// A descriptor is one 32-bit word: bits 0-19 the slot in its block, 20-23
// the block's rank, and flags
constexpr uint32_t kSlot = 0x000FFFFFu;
constexpr int kRankShift = 20;
constexpr uint32_t kRankMask = 0xFu;
constexpr uint32_t kRemote = 1u << 24;      // in another block of the cluster
// forward
constexpr uint32_t kPin = 1u << 25;         // a pinned node
constexpr uint32_t kSpecial = 1u << 26;     // node: PE output; operand: const
// backward
constexpr uint32_t kNoPush = 1u << 25;      // no producer
constexpr uint32_t kBase1 = 1u << 26;       // the min starts at 1
constexpr uint32_t kFixed = 1u << 27;       // fixed this cycle (per launch)
constexpr uint32_t kSkip = 1u << 28;        // producer fixed (per launch)
constexpr int kOpShift = 24;                // a data record's op + 1

struct Args {
    const int* node_of;     // (N,) node in each slot
    const int* fwd_desc;    // (N,) forward descriptor of each slot
    const int* pin_of;      // (N,) index into the pins of each slot, or -1
    const int* bwd_desc;    // (N,) backward descriptor of each slot
    const int4* rec_d;      // (R, 2) data PE records, by block
    const int4* rec_v;      // (R,) valid PE records, by block
    const int* rec_off;     // (C + 1,) each block's first record
    const int* pins_d;      // (n_pin,)
    const int* pins_v;
    const unsigned char* fix_mask;  // (N,) bool
    const int* fix_val;     // (N,)
    int *d0, *d1, *v0, *v1, *r0, *r1;  // the cycle's buffers 0 and 1
    int N, depth, word;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Read (rank, slot) d of the vector at shared-window address `base`: from
// this block's shared memory, or with kRemote through the cluster's
// distributed shared memory. Both loads are predicated in one asm block,
// so that a thread's kUnroll loads are in flight at once.
__device__ __forceinline__ int32_t load(uint32_t d, uint32_t base) {
    const uint32_t addr = base + ((d & kSlot) << 2);
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

// min-reduce v into (rank, slot) d of the vector at `base`.
__device__ __forceinline__ void push_min(uint32_t d, uint32_t base,
                                         int32_t v) {
    const uint32_t addr = base + ((d & kSlot) << 2);
    asm volatile(
        "{\n\t.reg .pred far;\n\t.reg .b32 ra;\n\t"
        "setp.ne.b32 far, %2, 0;\n\t"
        "mapa.shared::cluster.u32 ra, %0, %3;\n\t"
        "@far red.shared::cluster.min.s32 [ra], %1;\n\t"
        "@!far red.shared.min.s32 [%0], %1;\n\t}"
        :
        : "r"(addr), "r"(v), "r"(d & kRemote),
          "r"((d >> kRankShift) & kRankMask)
        : "memory");
}

// A PE operand: the constant c (kSpecial), else the value o locates in
// the previous vector `sv` (a PE's inputs are its connection boxes'
// ports, never a pinned node). The load runs either way (kSpecial's own
// bits locate slot 0 of this block).
__device__ __forceinline__ int32_t operand(int o, int c, uint32_t sv) {
    const int32_t v = load((uint32_t)o, sv);
    return ((uint32_t)o & kSpecial) ? c : v;
}

// This block's part of its cluster's vector.
struct Part {
    int rank, lo, nodes, chunk;
};

__device__ __forceinline__ Part make_part(const Args& a) {
    cg::cluster_group cluster = cg::this_cluster();
    const int c = (int)cluster.num_blocks();
    Part p;
    p.chunk = ((a.N + c) / c + 3) & ~3;     // ceil((N + 1) / c), to 4
    p.rank = (int)cluster.block_rank();
    p.lo = p.rank * p.chunk;
    const int hi = min(a.N, p.lo + p.chunk);
    p.nodes = hi > p.lo ? hi - p.lo : 0;
    return p;
}

// The data (valid == false) or valid cluster: `depth` forward sweeps.
__device__ void forward(const Args& a, const Part& p, int* smem,
                        bool valid) {
    cg::cluster_group cluster = cg::this_cluster();
    int* const val0 = smem;
    int* const val1 = smem + p.chunk;
    uint32_t* desc = reinterpret_cast<uint32_t*>(smem + 2 * p.chunk);
    int4* rec = reinterpret_cast<int4*>(smem + 3 * p.chunk);
    const uint32_t s0 = smem_addr(val0), s1 = smem_addr(val1);
    int* const buf0 = valid ? a.v0 : a.d0;
    int* const buf1 = valid ? a.v1 : a.d1;
    const int* pins = valid ? a.pins_v : a.pins_d;
    const int r0 = __ldg(a.rec_off + p.rank);
    const int n_rec = __ldg(a.rec_off + p.rank + 1) - r0;
    const int rec_words = valid ? 1 : 2;
    const int4* recs = valid ? a.rec_v : a.rec_d;
    for (int j = threadIdx.x; j < n_rec * rec_words; j += blockDim.x)
        rec[j] = recs[(size_t)r0 * rec_words + j];
#pragma unroll 4
    for (int k = threadIdx.x; k < p.chunk; k += blockDim.x) {
        const int pos = p.lo + k;
        if (pos < a.N) {
            const int node = __ldg(a.node_of + pos);
            desc[k] = (uint32_t)__ldg(a.fwd_desc + pos);
            val0[k] = buf0[node];
            const int pin = __ldg(a.pin_of + pos);
            val1[k] = pin >= 0 ? __ldg(pins + pin) : 0;
        } else if (pos == a.N) {            // the sentinel reads 0
            val0[k] = 0;
            val1[k] = 0;
        }
    }
    cluster.sync();
    const int step = kUnroll * (int)blockDim.x;
    for (int t = 0; t < a.depth; ++t) {
        const uint32_t sv = (t & 1) ? s1 : s0;
        int* to = (t & 1) ? val0 : val1;
        // the block's PE outputs first, packed, while the other warps
        // start on the nodes
        for (int j = threadIdx.x; j < n_rec; j += blockDim.x) {
            if (valid) {
                const int4 h = rec[j];      // slot, a, b; absent: 1
                const int32_t x = operand(h.y, 1, sv);
                const int32_t y = operand(h.z, 1, sv);
                to[h.x & kSlot] = x < y ? x : y;
            } else {
                const int4 h = rec[2 * j];  // slot | op, const, a
                const int4 g = rec[2 * j + 1];  // b, c
                const int op = ((uint32_t)h.x >> kOpShift) - 1;  // -1: res1
                to[h.x & kSlot] =
                    pe_alu(op, operand(h.z, h.w, sv),
                           operand(g.x, g.y, sv),
                           operand(g.z, g.w, sv), 0, 0, h.y) & a.word;
            }
        }
        for (int k0 = threadIdx.x; k0 < p.nodes; k0 += step) {
            uint32_t d[kUnroll];
            int32_t v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int k = k0 + u * (int)blockDim.x;
                d[u] = k < p.nodes ? desc[k] : kSpecial;
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) v[u] = load(d[u], sv);
            // a PE output is its record's; a pin stays in sweep 0
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
                if (!(d[u] & kSpecial) && !(t == 0 && (d[u] & kPin)))
                    to[k0 + u * (int)blockDim.x] = v[u];
        }
        cluster.sync();
    }
    // after the last barrier only this block's own slots are read
    for (int k = threadIdx.x; k < p.nodes; k += blockDim.x) {
        const int node = __ldg(a.node_of + p.lo + k);
        buf0[node] = val0[k];
        buf1[node] = val1[k];
    }
}

// The ready cluster: `depth` backward sweeps.
__device__ void backward(const Args& a, const Part& p, int* smem) {
    cg::cluster_group cluster = cg::this_cluster();
    // buffer b at smem + b * chunk
    uint32_t* desc = reinterpret_cast<uint32_t*>(smem + 3 * p.chunk);
    const uint32_t sbase = smem_addr(smem);
#pragma unroll 4
    for (int k = threadIdx.x; k < p.nodes; k += blockDim.x) {
        const int pos = p.lo + k;
        const int node = __ldg(a.node_of + pos);
        uint32_t d = (uint32_t)__ldg(a.bwd_desc + pos);
        const bool fixed = a.fix_mask[node] != 0;
        if (!(d & kNoPush)) {
            const int from = (int)(((d >> kRankShift) & kRankMask) * p.chunk +
                                   (d & kSlot));
            if (a.fix_mask[__ldg(a.node_of + from)]) d |= kSkip;
        }
        const int start = fixed ? a.fix_val[node]
                                : ((d & kBase1) ? 1 : INT32_MAX);
        desc[k] = fixed ? d | kFixed : d;
        smem[k] = a.r0[node];
        smem[p.chunk + k] = start;
        smem[2 * p.chunk + k] = start;
    }
    cluster.sync();
    const int step = kUnroll * (int)blockDim.x;
    for (int t = 0, cur = 0; t < a.depth; ++t, cur = cur == 2 ? 0 : cur + 1) {
        const int nxt = cur == 2 ? 0 : cur + 1;
        const int* from = smem + cur * p.chunk;
        const int* to = smem + nxt * p.chunk;
        int* reset = smem + (nxt == 2 ? 0 : nxt + 1) * p.chunk;
        const uint32_t sto = sbase + 4u * (uint32_t)(nxt * p.chunk);
        for (int k0 = threadIdx.x; k0 < p.nodes; k0 += step) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int k = k0 + u * (int)blockDim.x;
                if (k >= p.nodes) break;
                const uint32_t d = desc[k];
                if (!(d & (kNoPush | kSkip))) push_min(d, sto, from[k]);
                // nothing pushes into a fixed slot: it keeps fix_val
                reset[k] = (d & kFixed) ? to[k]
                                        : ((d & kBase1) ? 1 : INT32_MAX);
            }
        }
        cluster.sync();
    }
    const int* last = smem + (a.depth % 3) * p.chunk;
    const int* before = smem + ((a.depth + 2) % 3) * p.chunk;
    int* const to_last = (a.depth & 1) ? a.r1 : a.r0;
    int* const to_before = (a.depth & 1) ? a.r0 : a.r1;
    for (int k = threadIdx.x; k < p.nodes; k += blockDim.x) {
        const int node = __ldg(a.node_of + p.lo + k);
        to_last[node] = last[k];
        to_before[node] = before[k];
    }
}

__global__ void __launch_bounds__(kThreads, 1) rv_sweeps_kernel(Args a) {
    extern __shared__ __align__(16) int smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const Part p = make_part(a);
    const int role = blockIdx.x / (int)cluster.num_blocks();
    // after each part's last barrier a block reads only its own slots,
    // so it may leave
    if (role == 2)
        backward(a, p, smem);
    else
        forward(a, p, smem, role == 1);
}

// Shared memory of one block: the larger of the forward layout (12 B a
// slot, 32 B a data record, room for `room`) and the backward one (16 B a
// slot).
size_t rv_smem(int n, int room, int cluster) {
    const size_t chunk = (size_t)(((n + cluster) / cluster + 3) & ~3);
    const size_t fwd = 12 * chunk + (size_t)32 * room, bwd = 16 * chunk;
    return fwd > bwd ? fwd : bwd;
}

}  // namespace

// One cycle's sweeps: three clusters of `cluster` blocks (data, valid,
// ready) of one launch, room for `room` PE records a block; `depth` >= 1.
// d0 .. r1 are the cycle's buffers, written in place.
extern "C" int canal_rv_sweeps(
    const int* node_of, const int* fwd_desc, const int* pin_of,
    const int* bwd_desc, const int* rec_d, const int* rec_v,
    const int* rec_off, const int* pins_d, const int* pins_v,
    const unsigned char* fix_mask, const int* fix_val, int* d0, int* d1,
    int* v0, int* v1, int* r0, int* r1, int N, int room, int depth,
    int word, int cluster, void* stream) {
    Args a;
    a.node_of = node_of; a.fwd_desc = fwd_desc; a.pin_of = pin_of;
    a.bwd_desc = bwd_desc;
    a.rec_d = reinterpret_cast<const int4*>(rec_d);
    a.rec_v = reinterpret_cast<const int4*>(rec_v);
    a.rec_off = rec_off; a.pins_d = pins_d; a.pins_v = pins_v;
    a.fix_mask = fix_mask; a.fix_val = fix_val;
    a.d0 = d0; a.d1 = d1; a.v0 = v0; a.v1 = v1; a.r0 = r0; a.r1 = r1;
    a.N = N; a.depth = depth; a.word = word;
    return launch_cluster(rv_sweeps_kernel, 3 * cluster, kThreads, cluster,
                          rv_smem(N, room, cluster), (cudaStream_t)stream,
                          a);
}

// How many clusters of `cluster` blocks at N nodes and `room` PE records
// a block the card holds at once (0: none).
extern "C" int canal_rv_sweeps_clusters(int N, int room, int cluster,
                                        int* active) {
    return max_active_clusters(rv_sweeps_kernel, kThreads, cluster,
                               rv_smem(N, room, cluster), active);
}

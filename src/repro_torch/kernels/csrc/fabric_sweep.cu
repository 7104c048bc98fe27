// Single combinational sweeps of the fabric for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels in repro/kernels/fabric_step.py:
//   canal_fabric_sweep        <- fabric_sweep       (_sweep_kernel)
//   canal_fabric_sweep_batch  <- fabric_sweep_batch (_sweep_batch_kernel)
//
// One sweep gives every node the value of its selected mux input:
//
//   out[i]    = vals[src[i, sel[i]]]              (one configuration)
//   out[b, i] = vals[b, src[i, sel[b, i]]]        (B configurations, one
//                                                  shared src table)
//
// with the zero sentinel at vals[N] (src pads absent fan-in with N). The
// hold of undriven nodes (``keep``) stays outside, in the caller, as in
// the reference.
//
// Bound: bytes. Each output reads its select, one src entry and one
// value: a gather with no arithmetic.
//
// One configuration: at the Amber FULL size (N 86,288, F 20) the byte
// bound is ~0.4 us (this run's selects pick 1.33 MB of sel, src, vals and
// out), under the ~1.6 us any launch takes on this card, so one sweep
// alone can reach neither. What is left above that floor is latency:
// each node is a chain of three dependent loads (sel, then its src pick,
// then the value) before its store. A thread owns kNodes consecutive
// nodes: one 16-B load of their selects, then all kNodes src picks and
// all kNodes value gathers issued before any is used (kNodes independent
// chains in flight, not one), then one 16-B store. src and vals go
// through the read-only path; sel and out take plain loads and stores,
// with no evict-first hint, since the caller's next sweep of the same
// cycle reads them again (src, vals, sel and out together, ~7.9 MB at
// FULL, stay in the 50 MB L2 across a cycle's sweeps). sel or out not
// 16-B aligned take a scalar path; the N % kNodes tail nodes go one a
// thread. The grid is one wave (fabric_step.sweep_tiles, beside the
// wrapper): blocks spread over every SM where N allows, never more than
// the card holds at once, past which threads stride. In the port the
// sweep runs inside a CUDA graph of the whole sweep iteration
// (core/lowering.py), which is where the launch floor is paid down.
//
// B configurations: a thread owning one (b, i) and reading src[i, sel]
// from device memory would make a warp touch 32 separate 32-B sectors of
// src (rows are F x 4 B apart) for every configuration: at the Amber
// FULL size (F 20), 1 KB of L2 traffic per warp and configuration for
// 128 B used, two thirds of all such a kernel moves. Here a block owns a
// tile of TN nodes and a group of BB configurations. It copies the tile's
// src rows (contiguous, TN x F x 4 B) into shared memory once, with 16-B
// loads, and reuses them for each of its configurations, so src costs
// one read per tile and group instead of one sector per (b, i). Rows are
// padded to an odd length and a thread's four nodes lie TN / 4 rows
// apart, so a warp's picks fall in distinct banks when its selects agree.
// A thread owns four consecutive nodes of the tile and every lanes-th
// configuration of the group (the block is TN / 4 x lanes threads, so a
// tile's shared memory serves lanes warps per 32 node quads): per
// configuration one 16-B streaming load of sel, four picks from shared
// memory, four gathers of vals[b] through the read-only path and one
// 16-B streaming store, kUnroll configurations at a time (16 gathers in
// flight). Node tiles are the fastest grid dimension, so a group's BB
// rows of vals (345 KB each at FULL) stay in the 50 MB L2 while every
// tile of the group runs; sel and out stream past it (evict-first).
// TN, lanes, BB and the grid come from fabric_step.sweep_batch_tiles, in
// Python beside the wrapper: at FULL TN 256, 4 lanes, BB 16 (larger
// groups keep too many vals rows in L2 at once, smaller ones restage the
// tile too often). A wider fan-in takes a smaller tile, down to 4 nodes.
#include <cuda_runtime.h>

namespace {

constexpr int kNodes = 4;           // consecutive nodes a sweep thread owns
constexpr int kMaxSweepThreads = 256;
constexpr int kVec = 4;             // consecutive nodes a batch thread owns
constexpr int kMaxTile = 512;       // nodes of a tile, at most
constexpr int kMaxThreads = 512;    // tile threads x configuration lanes
constexpr int kUnroll = 4;          // configurations in flight a thread

// kNodes consecutive ints, loaded and stored whole (16 B for 4 nodes)
struct alignas(4 * kNodes) NodeInts {
    int v[kNodes];
};

// Thread t of the grid's S owns node groups t, t + S, ... (kNodes nodes
// each) of the first `groups`, then tail nodes kNodes * groups + t,
// + S, ...; aligned: sel and out start on 4 kNodes bytes (16 B).
__global__ void __launch_bounds__(kMaxSweepThreads)
sweep_kernel(const int* __restrict__ vals, const int* __restrict__ src,
             const int* __restrict__ sel, int* __restrict__ out, int n,
             int f, int aligned) {
    const int stride = gridDim.x * blockDim.x;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int groups = aligned ? n / kNodes : 0;
    for (int g = t; g < groups; g += stride) {
        const int i = g * kNodes;
        const NodeInts s = *reinterpret_cast<const NodeInts*>(sel + i);
        const int* row = src + (size_t)i * f;
        NodeInts v;
#pragma unroll
        for (int j = 0; j < kNodes; ++j)
            v.v[j] = __ldg(row + (size_t)j * f + s.v[j]);
#pragma unroll
        for (int j = 0; j < kNodes; ++j) v.v[j] = __ldg(vals + v.v[j]);
        *reinterpret_cast<NodeInts*>(out + i) = v;
    }
    for (int i = groups * kNodes + t; i < n; i += stride)
        out[i] = __ldg(vals + __ldg(src + (size_t)i * f + sel[i]));
}

// Copy src rows i0 .. i0 + nodes - 1 (contiguous in device memory) into
// the tile: node r at tile row (r % 4) * q + r / 4, rows ld words apart.
// Thread t of the block's nt copies words 4 t, 4 (t + nt), ...
__device__ __forceinline__ void stage_tile(int* tile,
                                           const int* __restrict__ s0,
                                           int nodes, int f, int ld, int q,
                                           int t, int nt, bool aligned) {
    const int words = nodes * f;
    const int quads = aligned ? words / 4 : 0;
    if (quads > 0) {
        // word k = 4 v at (rb, cb); a thread's next word is 4 nt further
        int rb = 4 * t / f, cb = 4 * t - rb * f;
        const int dr = 4 * nt / f, dc = 4 * nt - dr * f;
        for (int v = t; v < quads; v += nt) {
            const int4 w = __ldg(reinterpret_cast<const int4*>(s0) + v);
            const int e4[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int r = rb, c = cb + e;
                while (c >= f) {
                    c -= f;
                    ++r;
                }
                tile[((r & 3) * q + (r >> 2)) * ld + c] = e4[e];
            }
            rb += dr;
            cb += dc;
            if (cb >= f) {
                cb -= f;
                ++rb;
            }
        }
    }
    for (int k = 4 * quads + t; k < words; k += nt) {
        const int r = k / f, c = k - r * f;
        tile[((r & 3) * q + (r >> 2)) * ld + c] = __ldg(s0 + k);
    }
}

// U configurations b, b + step, ..., b + (U - 1) step of the thread's
// nodes i .. i + cnt - 1, whose src rows start at tile + row[j].
template <int U>
__device__ __forceinline__ void sweep_configs(
        const int* __restrict__ vals, const int* __restrict__ sel,
        int* __restrict__ out, const int* tile, const int (&row)[kVec],
        int b, int step, int i, int cnt, int n, int v_len, bool vec) {
    int s[U][kVec];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int* sp = sel + (size_t)(b + u * step) * n + i;
        if (vec) {
            const int4 w = __ldcs(reinterpret_cast<const int4*>(sp));
            s[u][0] = w.x;
            s[u][1] = w.y;
            s[u][2] = w.z;
            s[u][3] = w.w;
        } else {
#pragma unroll
            for (int j = 0; j < kVec; ++j)
                s[u][j] = j < cnt ? __ldcs(sp + j) : 0;
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < kVec; ++j) s[u][j] = tile[row[j] + s[u][j]];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int* vb = vals + (size_t)(b + u * step) * v_len;
#pragma unroll
        for (int j = 0; j < kVec; ++j)
            s[u][j] = j < cnt ? __ldg(vb + s[u][j]) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        int* op = out + (size_t)(b + u * step) * n + i;
        if (vec) {
            __stcs(reinterpret_cast<int4*>(op),
                   make_int4(s[u][0], s[u][1], s[u][2], s[u][3]));
        } else {
#pragma unroll
            for (int j = 0; j < kVec; ++j)
                if (j < cnt) __stcs(op + j, s[u][j]);
        }
    }
}

// Block (x, y): node tile x (TN = 4 x blockDim.x nodes) and the
// configuration groups y, y + gridDim.y, ... of bb configurations each.
// Thread (t, lane) owns nodes 4 t .. 4 t + 3 of the tile for the group's
// configurations lane, lane + blockDim.y, ...
__global__ void __launch_bounds__(kMaxThreads)
sweep_batch_kernel(const int* __restrict__ vals, const int* __restrict__ src,
                   const int* __restrict__ sel, int* __restrict__ out,
                   int B, int n, int f, int v_len, int bb, int aligned) {
    extern __shared__ int tile[];
    const int q = blockDim.x, lanes = blockDim.y;
    const int ld = f | 1;
    const int i0 = blockIdx.x * kVec * q;
    const int nodes = min(kVec * q, n - i0);
    const int t = threadIdx.x, lane = threadIdx.y;
    stage_tile(tile, src + (size_t)i0 * f, nodes, f, ld, q, lane * q + t,
               lanes * q, aligned);
    __syncthreads();
    const int r0 = kVec * t;
    if (r0 >= nodes) return;
    const int cnt = min(kVec, nodes - r0);
    const int i = i0 + r0;
    const bool vec = aligned && (n & 3) == 0 && cnt == kVec;
    int row[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) row[j] = (j * q + t) * ld;
    for (int g0 = blockIdx.y * bb; g0 < B; g0 += gridDim.y * bb) {
        const int g1 = min(B, g0 + bb);
        int b = g0 + lane;
        for (; b + (kUnroll - 1) * lanes < g1; b += kUnroll * lanes)
            sweep_configs<kUnroll>(vals, sel, out, tile, row, b, lanes, i,
                                   cnt, n, v_len, vec);
        for (; b < g1; b += lanes)
            sweep_configs<1>(vals, sel, out, tile, row, b, lanes, i, cnt, n,
                             v_len, vec);
    }
}

}  // namespace

// blocks and threads come from fabric_step.sweep_tiles; aligned: sel and
// out both start on 4 kNodes bytes (vector loads and stores).
extern "C" int canal_fabric_sweep(const int* vals, const int* src,
                                  const int* sel, int* out, int n, int f,
                                  int blocks, int threads, int aligned,
                                  void* stream) {
    if (blocks < 1 || threads < 32 || threads > kMaxSweepThreads ||
        threads % 32 != 0 || f < 1)
        return (int)cudaErrorInvalidValue;
    sweep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        vals, src, sel, out, n, f, aligned);
    return (int)cudaGetLastError();
}

// tn, lanes, bb, grid_y and smem (bytes of the staged tile) come from
// fabric_step.sweep_batch_tiles; aligned: src, sel and out all start on
// 16 B (16-B loads and stores).
extern "C" int canal_fabric_sweep_batch(const int* vals, const int* src,
                                        const int* sel, int* out, int B,
                                        int n, int f, int v_len, int tn,
                                        int lanes, int bb, int grid_y,
                                        int smem, int aligned,
                                        void* stream) {
    if (tn <= 0 || tn % kVec != 0 || tn > kMaxTile || lanes < 1 ||
        tn / kVec * lanes > kMaxThreads || bb < 1 || grid_y < 1 || f < 1 ||
        (size_t)smem < sizeof(int) * (size_t)tn * (f | 1))
        return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + tn - 1) / tn, grid_y);
    const dim3 block(tn / kVec, lanes);
    sweep_batch_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        vals, src, sel, out, B, n, f, v_len, bb, aligned);
    return (int)cudaGetLastError();
}

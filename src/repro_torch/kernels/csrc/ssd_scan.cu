// Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:96 (ssd_scan,
// _ssd_kernel): x (BH, L, P), dt (BH, L), a (BH,), b and c (BH, L, N),
// all float32, give y (BH, L, P). L is walked in K chunks of C,
// zero-padded at the end (a padded dt of 0 leaves the state alone). Per
// chunk k, as the reference kernel computes it:
//   seg  = cumsum(dt * a)
//   y    = (c h_k^T) * exp(seg)  +  ((c b^T) * tril(exp(seg_t - seg_u))
//                                    * dt_u) x
//   h_k+1 = exp(seg_last) h_k + s_k,
//   s_k   = (x * (dt * exp(seg_last - seg)))^T b
// all in float32 on the CUDA cores (no TF32).
//
// Design: the TPU kernel carries the (P, N) state in VMEM along a
// sequential grid axis. Here the chunks run in parallel and only the
// state is carried, in three launches on one stream:
//   1. ssd_state_kernel, one block per (batch*head, chunk) but the last:
//      seg by a warp-shuffle scan, the chunk's own state contribution s_k
//      (N x P, a C-deep product) into a float32 scratch (BH, K, N, P), and
//      exp(seg_last) into (BH, K).
//   2. ssd_carry_kernel, one thread per (batch*head, 4 state elements):
//      h_0 = 0, h_k = exp(seg_last_k-1) h_k-1 + s_k-1, sequential over the
//      K chunks but with every chunk's load issued first, written over
//      s_k in place (slot k ends holding h_k).
//   3. ssd_output_kernel, one block per (batch*head, chunk): the scores
//      c b^T and c h_k^T over state tiles of kNT dims, then the weights,
//      then y. Only the causal triangle of c b^T and of w x is computed:
//      a thread owns rows t = ty + 16 i and columns u = tx + 16 j (i, j <
//      C / 16), so the blocks i < j, wholly above the diagonal, are
//      skipped at compile time (28 of 64 at C 128).
// Passes 1 and 3 move as many bytes from device memory as their FLOPs
// take on the CUDA cores, so each streams its operands into shared
// memory through a cp.async ring of kStages stages (pass 1: 32 chunk
// rows of x and b a stage; pass 3: kNT state dims of c, b and h_k a
// stage), the next in flight while the block computes on one. At
// Mamba2's (C, P, N) = (128, 64, 128), pass 3 takes ~105 KB of shared
// memory (two blocks an SM), pass 1 ~50 KB (three). Threads keep 8 x 4
// (pass 1: state dims x head dims) or 8 x 8 + 8 x 4 (pass 3)
// accumulators in registers and read their operands from shared memory
// with 8- and 16-B loads that a warp shares or that fall in distinct
// banks. The templates take any C that is a multiple of 32 up to 256 and
// P, N multiples of 16 (the per-thread counts scale with them); they are
// instantiated for (128, 64, 128) and for the smoke configs' (32, 16,
// 16), at which a thread holds 1 x 1 (pass 1) or 2 x 2 + 2 x 1 (pass 3)
// values and most of the 16 x 16 map's work is idle. The wrapper pads or
// splits every other shape onto these two.
//
// Bound: operations. Per (batch*head, chunk) the causal work is ~5.2
// MFLOP in pass 3 and 2.1 MFLOP in pass 1, against ~0.2 MB of inputs: the
// float32 CUDA-core rate bounds it. The split costs device-memory
// traffic: b and x are read twice, and a chunk's 32 KB of state scratch
// is written, read, rewritten and read again.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kUT = 32;          // chunk rows of x and b per pass-1 stage
constexpr int kNT = 16;          // state dims of c, b, h_k per pass-3 stage
constexpr int kCarry = 16;       // chunk states in flight a pass-2 thread
constexpr int kStages = 2;       // ring depth of passes 1 and 3

// The thread maps of an instantiation (C, P, N): 256 threads as 16 x 16,
// a thread owning CI = C / 16 chunk rows and CI columns of the scores
// (pass 3), NI = N / 16 state dims (pass 1) and PJ = P / 16 head dims.
// Instantiated for (128, 64, 128), Mamba2's, and (32, 16, 16), the smoke
// configs'; at the small one most of a thread's tile is a single value.
template <int C, int P, int N>
struct Shape {
    static_assert(C % kUT == 0 && N % kNT == 0, "whole stages");
    static_assert(C <= kThreads && P % 16 == 0 && N % 16 == 0,
                  "the 16 x 16 thread maps");
    static constexpr int CI = C / 16, NI = N / 16, PJ = P / 16;
    static constexpr int LDN = kNT + 2;    // c, b stages [C][LDN]
    static constexpr int LDW = C + 16;     // weights [C][LDW]
    // pass 1: kStages stages of x [kUT][P] and b [kUT][N]; coef, seg,
    // dt, warp sums
    static constexpr int rows = kUT * (P + N);
    static constexpr int state_floats = kStages * rows + 3 * C + 32;
    // pass 3: kStages stages of c, b [C][LDN] and h_k [kNT][P], later the
    // weights; x [C][P]; seg, dt, warp sums
    static constexpr int stage = 2 * C * LDN + kNT * P;
    static constexpr int ring = kStages * stage;
    static constexpr int region = ring > C * LDW ? ring : C * LDW;
    static constexpr int output_floats = region + C * P + 2 * C + 32;
    static_assert(rows % 4 == 0 && stage % 4 == 0 && region % 4 == 0 &&
                  (C * LDN) % 4 == 0, "float4 arrays start on 16 B");
};

// W consecutive floats at p (W a multiple of 4 or of 2, or 1, and p
// aligned to the vector), loaded as float4s, float2s or one float.
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[W]) {
    if constexpr (W % 4 == 0) {
#pragma unroll
        for (int i = 0; i < W / 4; ++i) {
            const float4 v = reinterpret_cast<const float4*>(p)[i];
            out[4 * i] = v.x;
            out[4 * i + 1] = v.y;
            out[4 * i + 2] = v.z;
            out[4 * i + 3] = v.w;
        }
    } else if constexpr (W % 2 == 0) {
#pragma unroll
        for (int i = 0; i < W / 2; ++i) {
            const float2 v = reinterpret_cast<const float2*>(p)[i];
            out[2 * i] = v.x;
            out[2 * i + 1] = v.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) out[i] = p[i];
    }
}

template <int W>
__device__ __forceinline__ void store_vec(float* p, const float (&in)[W]) {
    if constexpr (W % 4 == 0) {
#pragma unroll
        for (int i = 0; i < W / 4; ++i)
            reinterpret_cast<float4*>(p)[i] = make_float4(
                in[4 * i], in[4 * i + 1], in[4 * i + 2], in[4 * i + 3]);
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) p[i] = in[i];
    }
}

// kBytes (8 or 16) from device memory into shared memory without
// registers, or zeros where !valid (src is then not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    const int n = valid ? kBytes : 0;
    if constexpr (kBytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(n) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(d), "l"(src), "n"(kBytes), "r"(n)
                     : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

// seg = cumsum(dt * a) over the chunk (dt 0 past len), by a shuffle scan
// in each warp plus the earlier warps' totals; also dts = dt. Ends with a
// barrier.
template <int C>
__device__ __forceinline__ void chunk_seg(const float* __restrict__ dt,
                                          int len, float av, float* seg,
                                          float* dts, float* wsum) {
    static_assert(C % 32 == 0 && C <= kThreads, "one thread a step");
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    float v = 0.f;
    if (tid < C) {
        const float d = tid < len ? dt[tid] : 0.f;
        dts[tid] = d;
        v = d * av;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float up = __shfl_up_sync(0xffffffffu, v, o);
            if (lane >= o) v += up;
        }
        if (lane == 31) wsum[w] = v;
    }
    __syncthreads();
    if (tid < C) {
        float off = 0.f;
        for (int i = 0; i < w; ++i) off += wsum[i];
        seg[tid] = v + off;
    }
    __syncthreads();
}

// Rows u0 .. u0 + rows - 1 of a chunk's (rows past len zero) [*][W]
// float32 matrix at g (row 0 of the chunk) into shared memory at s.
template <int W>
__device__ __forceinline__ void stage_rows(float* s, const float* g, int u0,
                                           int rows, int len) {
    for (int v = threadIdx.x; v < rows * W / 4; v += kThreads) {
        const int u = u0 + v / (W / 4);
        const bool ok = u < len;
        cp_async<16>(s + 4 * v,
                     g + (size_t)(ok ? u : 0) * W + 4 * (v % (W / 4)), ok);
    }
}

// Pass 1, block (bh, k < K - 1): s_k[n][p] = sum_u b[u][n] x[u][p]
// dt_u exp(seg_last - seg_u); decay[bh, k] = exp(seg_last). Thread (ty,
// tx) owns n = NI ty + i, p = PJ tx + jp.
template <int C, int P, int N>
__global__ void __launch_bounds__(kThreads, 3)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ states, float* __restrict__ decay,
                 int L, int K) {
    using S = Shape<C, P, N>;
    constexpr int NI = S::NI, PJ = S::PJ;
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);  // kStages x (x, b)
    float* coef = ring + kStages * S::rows;         // dt exp(seg_last - seg)
    float* seg = coef + C;
    float* dts = seg + C;
    float* wsum = dts + C;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int bh = blockIdx.x, k = blockIdx.y;
    const int c0 = k * C, len = min(C, L - c0);
    const size_t row0 = (size_t)bh * L + c0;
    const float* xg = x + row0 * P;
    const float* bg = b + row0 * N;

    auto load_rows = [&](int st) {      // chunk rows st kUT .. of x, b
        if (st < C / kUT) {
            float* to = ring + (st % kStages) * S::rows;
            stage_rows<P>(to, xg, st * kUT, kUT, len);
            stage_rows<N>(to + kUT * P, bg, st * kUT, kUT, len);
        }
        cp_commit();
    };
    for (int st = 0; st < kStages - 1; ++st) load_rows(st);
    chunk_seg<C>(dt + row0, len, a[bh], seg, dts, wsum);
    const float seg_last = seg[C - 1];
    if (tid < C) coef[tid] = dts[tid] * expf(seg_last - seg[tid]);

    float acc[NI][PJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int jp = 0; jp < PJ; ++jp) acc[i][jp] = 0.f;
    for (int it = 0; it < C / kUT; ++it) {
        load_rows(it + kStages - 1);
        cp_wait<kStages - 1>();
        __syncthreads();
        const float* xs = ring + (it % kStages) * S::rows;  // [kUT][P]
        const float* bs = xs + kUT * P;                // [kUT][N]
#pragma unroll 4
        for (int uu = 0; uu < kUT; ++uu) {
            const float cf = coef[it * kUT + uu];
            float bv[NI], xv[PJ];
            load_vec<NI>(bs + uu * N + NI * ty, bv);
            load_vec<PJ>(xs + uu * P + PJ * tx, xv);
#pragma unroll
            for (int jp = 0; jp < PJ; ++jp) xv[jp] *= cf;
#pragma unroll
            for (int i = 0; i < NI; ++i)
#pragma unroll
                for (int jp = 0; jp < PJ; ++jp)
                    acc[i][jp] = fmaf(bv[i], xv[jp], acc[i][jp]);
        }
        __syncthreads();     // every reader done before the stage refills
    }
    float* out = states + ((size_t)bh * K + k) * N * P;
#pragma unroll
    for (int i = 0; i < NI; ++i)
        store_vec<PJ>(out + (NI * ty + i) * P + PJ * tx, acc[i]);
    if (tid == 0) decay[(size_t)bh * K + k] = expf(seg_last);
}

// Pass 2, one thread per (bh, 4 state elements): slot k of the scratch
// goes from s_k to h_k, h_0 = 0 (slot 0, never read, is left as it is),
// h_k = decay_k-1 h_k-1 + s_k-1.
__global__ void __launch_bounds__(kThreads)
ssd_carry_kernel(float4* states, const float* __restrict__ decay, int K,
                 int per_bh, long long total) {
    const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (idx >= total) return;
    const long long bh = idx / per_bh;
    float4* s = states + bh * K * per_bh + (idx - bh * per_bh);
    const float* d = decay + bh * K;
    float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < K - 1; k0 += kCarry) {
        float4 in[kCarry];
#pragma unroll
        for (int j = 0; j < kCarry; ++j)
            if (k0 + j < K - 1) in[j] = __ldcs(s + (size_t)(k0 + j) * per_bh);
#pragma unroll
        for (int j = 0; j < kCarry; ++j) {
            if (k0 + j < K - 1) {
                if (k0 + j > 0) s[(size_t)(k0 + j) * per_bh] = h;
                const float dk = d[k0 + j];
                h = make_float4(dk * h.x + in[j].x, dk * h.y + in[j].y,
                                dk * h.z + in[j].z, dk * h.w + in[j].w);
            }
        }
    }
    if (K > 1) s[(size_t)(K - 1) * per_bh] = h;
}

// Pass 3, block (bh, k): y for the chunk's rows. Thread (ty, tx) owns
// rows t = ty + 16 i, score columns u = tx + 16 j (i, j < CI) and head
// dims p = PJ tx + jp.
template <int C, int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_output_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c,
                  const float* __restrict__ states, float* __restrict__ y,
                  int L, int K) {
    using S = Shape<C, P, N>;
    constexpr int LDN = S::LDN, LDW = S::LDW, CI = S::CI, PJ = S::PJ;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* ws = smem;                 // [C][LDW] weights, over the stages
    float* xs = smem + S::region;     // [C][P]
    float* seg = xs + C * P;
    float* dts = seg + C;
    float* wsum = dts + C;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int bh = blockIdx.x, k = blockIdx.y;
    const int c0 = k * C, len = min(C, L - c0);
    const size_t row0 = (size_t)bh * L + c0;
    const bool carried = k > 0;       // h_0 = 0
    const float* hg = states + ((size_t)bh * K + k) * N * P;

    // stage: c [C][LDN], b [C][LDN], h_k [kNT][P] of state dims n0 ..
    auto load_stage = [&](int n0, float* st) {
        for (int v = tid; v < C * kNT / 2; v += kThreads) {
            const int t = v / (kNT / 2), q = v % (kNT / 2);
            const bool ok = t < len;
            const size_t g = (row0 + (ok ? t : 0)) * N + n0 + 2 * q;
            cp_async<8>(st + t * LDN + 2 * q, c + g, ok);
            cp_async<8>(st + C * LDN + t * LDN + 2 * q, b + g, ok);
        }
        if (carried)
            for (int v = tid; v < kNT * P / 4; v += kThreads)
                cp_async<16>(st + 2 * C * LDN + 4 * v, hg + n0 * P + 4 * v,
                             true);
    };
    // one cp.async group a stage; x (first read after the last stage)
    // rides with the last stage of the prologue
    for (int st = 0; st < kStages - 1; ++st) {
        load_stage(st * kNT, smem + st * S::stage);
        if (st == kStages - 2) stage_rows<P>(xs, x + row0 * P, 0, C, len);
        cp_commit();
    }
    chunk_seg<C>(dt + row0, len, a[bh], seg, dts, wsum);

    float sacc[CI][CI], yacc[CI][PJ];
#pragma unroll
    for (int i = 0; i < CI; ++i) {
#pragma unroll
        for (int j = 0; j < CI; ++j) sacc[i][j] = 0.f;
#pragma unroll
        for (int jp = 0; jp < PJ; ++jp) yacc[i][jp] = 0.f;
    }
    for (int it = 0; it < N / kNT; ++it) {
        const int next = it + kStages - 1;
        if (next < N / kNT)
            load_stage(next * kNT, smem + (next % kStages) * S::stage);
        cp_commit();
        cp_wait<kStages - 1>();
        __syncthreads();
        const float* cs = smem + (it % kStages) * S::stage;  // [C][LDN]
        const float* bs = cs + C * LDN;                // [C][LDN]
        const float* hs = bs + C * LDN;                // [kNT][P]
#pragma unroll 2
        for (int nn = 0; nn < kNT; nn += 2) {
            float2 cv[CI];
#pragma unroll
            for (int i = 0; i < CI; ++i)
                cv[i] = *reinterpret_cast<const float2*>(
                    cs + (ty + 16 * i) * LDN + nn);
#pragma unroll
            for (int j = 0; j < CI; ++j) {
                const float2 bv = *reinterpret_cast<const float2*>(
                    bs + (tx + 16 * j) * LDN + nn);
#pragma unroll
                for (int i = 0; i < CI; ++i)
                    if (i >= j)
                        sacc[i][j] = fmaf(cv[i].y, bv.y,
                                          fmaf(cv[i].x, bv.x, sacc[i][j]));
            }
            if (carried) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float hv[PJ];
                    load_vec<PJ>(hs + (nn + e) * P + PJ * tx, hv);
#pragma unroll
                    for (int i = 0; i < CI; ++i) {
                        const float ce = e ? cv[i].y : cv[i].x;
#pragma unroll
                        for (int jp = 0; jp < PJ; ++jp)
                            yacc[i][jp] = fmaf(ce, hv[jp], yacc[i][jp]);
                    }
                }
            }
        }
        __syncthreads();     // every reader done before the stage refills
    }

    // w[t][u] = (c b^T)[t][u] exp(seg_t - seg_u) dt_u for t >= u, else 0;
    // y_inter = (c h_k^T) exp(seg_t)
#pragma unroll
    for (int i = 0; i < CI; ++i) {
        const int t = ty + 16 * i;
        const float seg_t = seg[t];
#pragma unroll
        for (int j = 0; j < CI; ++j) {
            if (i < j) continue;
            const int u = tx + 16 * j;
            ws[t * LDW + u] =
                t >= u ? sacc[i][j] * expf(seg_t - seg[u]) * dts[u] : 0.f;
        }
        const float decay_in = expf(seg_t);
#pragma unroll
        for (int jp = 0; jp < PJ; ++jp) yacc[i][jp] *= decay_in;
    }
    __syncthreads();

    // y += w x over u <= t: rows block i meets columns blocks jb <= i
#pragma unroll
    for (int jb = 0; jb < CI; ++jb) {
#pragma unroll 1
        for (int uu = 0; uu < 16; uu += 4) {
            const int u = 16 * jb + uu;
            float xv[4][PJ];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                load_vec<PJ>(xs + (u + e) * P + PJ * tx, xv[e]);
#pragma unroll
            for (int i = 0; i < CI; ++i) {
                if (i < jb) continue;
                const float4 wv = *reinterpret_cast<const float4*>(
                    ws + (ty + 16 * i) * LDW + u);
                const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
#pragma unroll
                    for (int jp = 0; jp < PJ; ++jp)
                        yacc[i][jp] = fmaf(w4[e], xv[e][jp], yacc[i][jp]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < CI; ++i) {
        const int t = ty + 16 * i;
        if (t < len) store_vec<PJ>(y + (row0 + t) * P + PJ * tx, yacc[i]);
    }
}

template <int C, int P, int N>
int launch(const float* x, const float* dt, const float* a, const float* b,
           const float* c, float* y, float* states, float* decay, int bh,
           int L, cudaStream_t stream) {
    using S = Shape<C, P, N>;
    const int K = (L + C - 1) / C;
    if (K > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem1 = S::state_floats * sizeof(float);
    const size_t smem3 = S::output_floats * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_state_kernel<C, P, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            ssd_output_kernel<C, P, N>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
    if (err != cudaSuccess) return (int)err;
    if (K > 1) {
        ssd_state_kernel<C, P, N><<<dim3(bh, K - 1), kThreads, smem1,
                                    stream>>>(x, dt, a, b, states, decay, L,
                                              K);
        const long long total = (long long)bh * (N * P / 4);
        ssd_carry_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(
            reinterpret_cast<float4*>(states), decay, K, N * P / 4, total);
    }
    ssd_output_kernel<C, P, N><<<dim3(bh, K), kThreads, smem3, stream>>>(
        x, dt, a, b, c, states, y, L, K);
    return (int)cudaGetLastError();
}

}  // namespace

// (chunk, P, N) = (128, 64, 128), Mamba2's, or (32, 16, 16), the smoke
// configs'; anything else is refused with cudaErrorInvalidValue (the
// wrapper pads or splits every shape onto these first). states: float32
// scratch of BH x K x N x P, decay: BH x K (K = ceil(L / chunk)), both
// allocated by the wrapper; x, b and c start on 16 B.
extern "C" int canal_ssd_scan(const float* x, const float* dt, const float* a,
                              const float* b, const float* c, float* y,
                              float* states, float* decay, int bh, int L,
                              int P, int N, int chunk, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (P == 64 && N == 128 && chunk == 128)
        return launch<128, 64, 128>(x, dt, a, b, c, y, states, decay, bh, L,
                                    st);
    if (P == 16 && N == 16 && chunk == 32)
        return launch<32, 16, 16>(x, dt, a, b, c, y, states, decay, bh, L,
                                  st);
    return (int)cudaErrorInvalidValue;
}

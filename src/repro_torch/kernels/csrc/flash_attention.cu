// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:94
// (flash_attention, _flash_kernel) together with the GQA wrapper of
// repro/kernels/ops.py:92-106: causal (or full) softmax attention on
// q (B, Hq, Sq, D) and k/v (B, Hkv, Skv, D), output (B, Hq, Sq, D) in q's
// dtype. The reference's numbers are kept: scores, the running max and
// the denominator are float32; masked scores are -1e30 (keys past Skv,
// and keys past the query position when causal, 0-based positions for
// both); the output divides by max(l, 1e-30). The Pallas version pads Sq
// and Skv to 128 for its tiling; here the ragged edges are masked
// instead. For GQA a block reads kv head h / (Hq / Hkv) in place.
//
// Two kernels, chosen by dtype in canal_flash_attention below; nothing
// falls back from one to the other. Both take every head dim D from 1 to
// 256; a third, flash_wide_kernel, takes every D past 256 in any of the
// three types (below). A D that is not a tile width runs at the next
// one up (DP: 64, 128
// or 256 on the tensor cores, a multiple of 32 on the CUDA cores) with
// the columns past D read as zeros, so Q K^T and P V are unchanged; only
// D columns of the output are stored, and the scale is 1/sqrt(D) of the
// true D. Phi-3's D 96 and Kimi K2's 112 do 4/3 and 8/7 of the work of
// their own width, the smoke configs' D 16 four times. TMA maps a 16-bit
// row only if it is a multiple of 16 bytes: where D is not a multiple of
// 8, the wrapper hands the kernel copies padded with zero columns (dm,
// the row width in memory, a multiple of 8) and keeps the first D
// columns of the output.
//
// bfloat16 and float16 (the LM path: B 2, Hq 32, Hkv 4, S 2048, D 64,
// causal, bf16) run flash_tc_kernel on the tensor cores, instantiated
// for either type: wgmma takes both, with the same fragments. D 129-256
// (RecurrentGemma's D 256) take a tile of 256 columns with 64-key tiles:
// the 64 x 256 float32 accumulator is 128 registers a consumer thread,
// beside 32 of scores and 32 of P, inside the consumers' 232 (ptxas: no
// spill). Bound: 4 D FLOPs
// per (query, key) pair, 34 GFLOP at that shape against 38 MB of bytes,
// so the bf16 tensor-core rate bounds it. Design, after FlashAttention-3:
//  - work items are (batch*head, 128-query tile) pairs, heaviest causal
//    tiles first; a persistent grid of one block per SM walks them in
//    snake order, so one item's last tiles and stores overlap the next
//    item's loads (any batch*head count: items are numbered, not laid
//    out on the grid);
//  - a block is two consumer warpgroups of 64 query rows (the wgmma M)
//    and a producer warpgroup, which gives its registers to the
//    consumers (setmaxnreg 40 / 232: the consumers hold S, P twice and O
//    at once) and of which one thread starts every copy;
//  - the producer loads an item's Q tile once, when the last item's
//    scores are done, and keeps K and V tiles (128 keys for D 64, 64 for
//    D 128) in flight in 2-stage shared-memory rings with TMA (128-byte
//    swizzle; rows past Sq/Skv read as zeros), guarded by full/empty
//    mbarriers; the tensor map encoder comes through
//    cudaGetDriverEntryPoint, so the build does not link libcuda;
//  - S = Q K^T is one bf16 wgmma chain from shared memory with float32
//    accumulation; the scale 1/sqrt(D) goes into the exponent, p =
//    exp2((s - m) scale log2(e)), one FMA and one ex2 a score. The
//    reference scales q before the dot: for D 64 the scale is 2^-3 and
//    both orders give the same scores bit for bit, for D 128 they differ
//    by float32 rounding only;
//  - the online softmax runs on the accumulator fragments (a row's values
//    sit in the four threads of a quad), masking only diagonal and ragged
//    tiles. A masked score is -1e30 before the scale, not after; the
//    results are the same, since every row sees key 0 in its first tile
//    and its running max is a real score from then on;
//  - O += P V keeps P in registers as the A operand of the next wgmma
//    (the accumulator fragment is already the A fragment layout) with V
//    from shared memory, MN-major (the transpose bit). P is carried as
//    two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), in two wgmmas
//    into the same float32 accumulator: P rounded once to bf16 errs by up
//    to 2^-8 relative, which at the LM shape breaks the kernel's
//    tolerance against the plain version (1e-4 + 2^-7 |want|); hi + lo
//    carries P to ~16 bits. That is 6 D tensor FLOPs a pair, not 4 D.
//    float16 carries P as two f16 terms alike (~22 bits where p is a
//    normal f16; smaller p are absolute errors below 2^-24), within one
//    f16 ulp (1e-4 + 2^-10 |want|);
//  - tile t's scores are started with tile t-1's P V, so a warpgroup's
//    softmax runs while the tensor cores work, and the two warpgroups
//    take turns at the tensor cores (named barriers). The first and
//    last tiles of an item are peeled out of the loop: ptxas serializes
//    wgmmas that sit on a conditional path.
//
// float32 runs flash_f32_kernel on the CUDA cores, in full float32 (q is
// multiplied by 1/sqrt(D) before the dot, as in the reference): one block
// per (batch*head, 64-query tile), batch*head on grid x (up to 2^31 - 1,
// where y stops at 65,535), 128 threads, tiles staged through
// shared memory, each thread a 4 x 8 block of scores and a 4 x (D / 8)
// block of the output, rows reduced over 8 threads with warp shuffles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -1.0e30f;

// ------------------------------------------------- float32, CUDA cores
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;    // 16 row groups (4 rows) x 8 column groups
constexpr int kLd = kBQ + 4;     // padded stride of the transposed tiles

static_assert(kBQ == kBK, "the transposed tiles share one stride");

template <int DP>
constexpr size_t f32_smem_bytes() {
    // qt [DP][kLd], kt [DP][kLd], vs [kBK][DP], pt [kBK][kLd]
    return (size_t)(2 * DP * kLd + kBK * DP + kBK * kLd) * sizeof(float);
}

// DP: the tile width, a multiple of 32 from 32 to 256; the head dim D
// (DP - 31 .. DP) is a launch argument, columns D..DP-1 read as 0.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int hq, int hkv, int sq, int skv, int D, int causal,
                 float scale) {
    constexpr int DJ = DP / 32;  // float4 column groups of the output
    extern __shared__ float4 smem4[];
    float* qt = reinterpret_cast<float*>(smem4);
    float* kt = qt + DP * kLd;
    float* vs = kt + DP * kLd;
    float* pt = vs + kBK * DP;

    const int tid = threadIdx.x;
    const int tx = tid & 7;      // column group: lanes 0-7 of a row group
    const int ty = tid >> 3;     // row group: query rows ty*4 .. ty*4+3
    // batch*head on grid x (up to 2^31 - 1), query tiles on y, heaviest
    // causal tiles first
    const int n_qt = (sq + kBQ - 1) / kBQ;
    const int q0 = (n_qt - 1 - (int)blockIdx.y) * kBQ;
    const int bh = blockIdx.x;
    const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
    const float* qp = q + (size_t)bh * sq * D;
    const float* kp = k + (size_t)kvh * skv * D;
    const float* vp = v + (size_t)kvh * skv * D;

    for (int i = tid; i < kBQ * DP; i += kThreads) {
        const int r = i / DP, d = i % DP;
        const int qr = q0 + r;
        qt[d * kLd + r] = qr < sq && d < D
                              ? qp[(size_t)qr * D + d] * scale : 0.f;
    }

    float m[4], l[4], acc[4][4 * DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4 * DJ; ++j) acc[i][j] = 0.f;
    }

    int n_kt = (skv + kBK - 1) / kBK;
    if (causal) {
        // only key tiles whose first key is at or before this query
        // tile's last live query can contribute
        const int last_q = min(q0 + kBQ, sq) - 1;
        n_kt = min(n_kt, last_q / kBK + 1);
    }

    for (int t = 0; t < n_kt; ++t) {
        const int k0 = t * kBK;
        __syncthreads();     // the last tile's readers are done
        for (int i = tid; i < kBK * DP; i += kThreads) {
            const int r = i / DP, d = i % DP;
            const bool live = k0 + r < skv && d < D;
            const size_t g = (size_t)(k0 + r) * D + d;
            kt[d * kLd + r] = live ? kp[g] : 0.f;
            vs[r * DP + d] = live ? vp[g] : 0.f;
        }
        __syncthreads();

        // scores: rows ty*4+i, columns tx*4+j (j < 4) and 32+tx*4+j-4
        float s[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < DP; ++d) {
            const float4 a = *reinterpret_cast<const float4*>(
                &qt[d * kLd + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(
                &kt[d * kLd + tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(
                &kt[d * kLd + 32 + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q0 + ty * 4 + i;
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int kpos = k0 + (j < 4 ? tx * 4 + j : 28 + tx * 4 + j);
                const bool live = kpos < skv && (!causal || qpos >= kpos);
                s[i][j] = live ? s[i][j] : kNegInf;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 1; off < 8; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                sum += s[i][j];
            }
#pragma unroll
            for (int off = 1; off < 8; off <<= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < 4 * DJ; ++j) acc[i][j] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = j < 4 ? tx * 4 + j : 28 + tx * 4 + j;
            *reinterpret_cast<float4*>(&pt[col * kLd + ty * 4]) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        }
        __syncthreads();

        // acc[i][g*4+e] += sum_c p[row i][c] * v[c][g*32 + tx*4 + e]
#pragma unroll 4
        for (int c = 0; c < kBK; ++c) {
            const float4 a = *reinterpret_cast<const float4*>(
                &pt[c * kLd + ty * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int g = 0; g < DJ; ++g) {
                const float4 vv = *reinterpret_cast<const float4*>(
                    &vs[c * DP + g * 32 + tx * 4]);
                const float vv4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[i][g * 4 + e] =
                            fmaf(av[i], vv4[e], acc[i][g * 4 + e]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty * 4 + i;
        if (qpos >= sq) continue;
        const float den = fmaxf(l[i], 1e-30f);
        float* orow = out + ((size_t)bh * sq + qpos) * D;
#pragma unroll
        for (int g = 0; g < DJ; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (g * 32 + tx * 4 + e < D)
                    orow[g * 32 + tx * 4 + e] = acc[i][g * 4 + e] / den;
    }
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int batch, int hq, int hkv, int sq, int skv, int d,
               int causal, cudaStream_t stream) {
    const size_t smem = f32_smem_bytes<DP>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    // the reference's scale: 1 / sqrt(D) in double, then float32
    const float scale = (float)(1.0 / std::sqrt((double)d));
    const long long bh = (long long)batch * hq;
    const int n_qt = (sq + kBQ - 1) / kBQ;
    if (bh > 0x7fffffffLL || n_qt > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)bh, n_qt);
    flash_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), hq, hkv, sq,
        skv, d, causal, scale);
    return (int)cudaGetLastError();
}

// ------------------------------ any head dim past 256, CUDA cores
// The head dims past the tile kernels' 256 run here, for float32,
// bfloat16 and float16 inputs alike, in float32 (inputs converted as they
// are staged; q multiplied by 1/sqrt(D) before the dot, as the plain
// version does). A simple kernel: one block per (batch*head, 64-query
// tile, 256-column panel of the output), 128 threads as in
// flash_f32_kernel. Each key tile's scores sum over the whole D, a
// 256-column panel of q and k at a time through shared memory; the
// online softmax and P V then run for the block's own panel of V. Every
// output panel recomputes the scores: D / 256 times the Q K^T work.
template <typename T>
__device__ __forceinline__ float wide_in(T x) { return (float)x; }
template <>
__device__ __forceinline__ float wide_in(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float wide_in(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T wide_out(float x) { return (T)x; }
template <>
__device__ __forceinline__ __nv_bfloat16 wide_out(float x) {
    return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half wide_out(float x) {
    return __float2half(x);
}

constexpr int kWidePanel = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int hq,
                  int hkv, int sq, int skv, int D, int causal, float scale) {
    constexpr int DJ = kWidePanel / 32;
    extern __shared__ float4 smem4[];
    float* qt = reinterpret_cast<float*>(smem4);
    float* kt = qt + kWidePanel * kLd;
    float* vs = kt + kWidePanel * kLd;
    float* pt = vs + kBK * kWidePanel;

    const int tid = threadIdx.x;
    const int tx = tid & 7;
    const int ty = tid >> 3;
    const int n_qt = (sq + kBQ - 1) / kBQ;
    const int q0 = (n_qt - 1 - (int)blockIdx.y) * kBQ;
    const int p0 = (int)blockIdx.z * kWidePanel;   // this block's columns
    const int bh = blockIdx.x;
    const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
    const T* qp = q + (size_t)bh * sq * D;
    const T* kp = k + (size_t)kvh * skv * D;
    const T* vp = v + (size_t)kvh * skv * D;

    float m[4], l[4], acc[4][4 * DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4 * DJ; ++j) acc[i][j] = 0.f;
    }

    int n_kt = (skv + kBK - 1) / kBK;
    if (causal) {
        const int last_q = min(q0 + kBQ, sq) - 1;
        n_kt = min(n_kt, last_q / kBK + 1);
    }

    for (int t = 0; t < n_kt; ++t) {
        const int k0 = t * kBK;
        float s[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
        for (int d0 = 0; d0 < D; d0 += kWidePanel) {
            __syncthreads();     // the last panel's readers are done
            for (int i = tid; i < kBQ * kWidePanel; i += kThreads) {
                const int r = i / kWidePanel, c = i % kWidePanel, d = d0 + c;
                const int qr = q0 + r, kr = k0 + r;
                qt[c * kLd + r] = qr < sq && d < D
                    ? wide_in(qp[(size_t)qr * D + d]) * scale : 0.f;
                kt[c * kLd + r] = kr < skv && d < D
                    ? wide_in(kp[(size_t)kr * D + d]) : 0.f;
            }
            __syncthreads();
#pragma unroll 8
            for (int c = 0; c < kWidePanel; ++c) {
                const float4 a = *reinterpret_cast<const float4*>(
                    &qt[c * kLd + ty * 4]);
                const float4 b0 = *reinterpret_cast<const float4*>(
                    &kt[c * kLd + tx * 4]);
                const float4 b1 = *reinterpret_cast<const float4*>(
                    &kt[c * kLd + 32 + tx * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                     b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
            }
        }
        for (int i = tid; i < kBK * kWidePanel; i += kThreads) {
            const int r = i / kWidePanel, c = i % kWidePanel, d = p0 + c;
            vs[r * kWidePanel + c] = k0 + r < skv && d < D
                ? wide_in(vp[(size_t)(k0 + r) * D + d]) : 0.f;
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q0 + ty * 4 + i;
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int kpos = k0 + (j < 4 ? tx * 4 + j : 28 + tx * 4 + j);
                const bool live = kpos < skv && (!causal || qpos >= kpos);
                s[i][j] = live ? s[i][j] : kNegInf;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 1; off < 8; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                sum += s[i][j];
            }
#pragma unroll
            for (int off = 1; off < 8; off <<= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < 4 * DJ; ++j) acc[i][j] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = j < 4 ? tx * 4 + j : 28 + tx * 4 + j;
            *reinterpret_cast<float4*>(&pt[col * kLd + ty * 4]) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < kBK; ++c) {
            const float4 a = *reinterpret_cast<const float4*>(
                &pt[c * kLd + ty * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int g = 0; g < DJ; ++g) {
                const float4 vv = *reinterpret_cast<const float4*>(
                    &vs[c * kWidePanel + g * 32 + tx * 4]);
                const float vv4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[i][g * 4 + e] =
                            fmaf(av[i], vv4[e], acc[i][g * 4 + e]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty * 4 + i;
        if (qpos >= sq) continue;
        const float den = fmaxf(l[i], 1e-30f);
        T* orow = out + ((size_t)bh * sq + qpos) * D;
#pragma unroll
        for (int g = 0; g < DJ; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = p0 + g * 32 + tx * 4 + e;
                if (d < D) orow[d] = wide_out<T>(acc[i][g * 4 + e] / den);
            }
    }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* out,
                int batch, int hq, int hkv, int sq, int skv, int d,
                int causal, cudaStream_t stream) {
    const size_t smem = f32_smem_bytes<kWidePanel>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const float scale = (float)(1.0 / std::sqrt((double)d));
    const long long bh = (long long)batch * hq;
    const int n_qt = (sq + kBQ - 1) / kBQ;
    const int panels = (d + kWidePanel - 1) / kWidePanel;
    if (bh > 0x7fffffffLL || n_qt > 65535 || panels > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)bh, n_qt, panels);
    flash_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv, d,
        causal, scale);
    return (int)cudaGetLastError();
}

// ------------------------------------ bfloat16 and float16, tensor cores
// T is __nv_bfloat16 or __half: wgmma takes either as its 16-bit input
// type, with the same fragment layouts; only the instruction's type names,
// the tensor maps' element type and the conversions differ.
template <typename T>
constexpr bool kIsHalf = false;
template <>
constexpr bool kIsHalf<__half> = true;

constexpr int kTcRows = 128;            // query rows per block
constexpr int kConsumers = 256;         // two warpgroups of 64 rows
constexpr int kTcThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kStages = 2;              // K/V ring depth
constexpr int kPanel = 64;              // bf16 columns of a 128-byte row
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory tiles are [rows][64] bf16 panels of 128-byte rows in the
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), one
// panel per 64 columns of D, as TMA writes them; every panel starts on a
// 1024-byte boundary.
template <int D>
struct TcTile {
    static constexpr int kKeys = D == 64 ? 128 : 64;   // keys per tile
    static constexpr int kPanels = D / kPanel;
    static constexpr uint32_t kQBytes = kTcRows * D * 2;
    static constexpr uint32_t kQPanel = kTcRows * 128;
    static constexpr uint32_t kKvBytes = kKeys * D * 2;  // K (or V) tile
    static constexpr uint32_t kKvPanel = kKeys * 128;
    // tiles, 4 x kStages + 2 8-byte barriers, slack to align the base
    static constexpr size_t kSmem =
        kQBytes + 2 * kStages * kKvBytes + 8 * (4 * kStages + 2) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// One TMA box {64 columns, rows, 1} at (col, row, head) into shared
// memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(col), "r"(row), "r"(head)
        : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
           (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers a wgmma reads or writes asynchronously: after the wait, these
// keep the compiler from touching them earlier (and from reusing a
// register the tensor cores still read).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// The three wgmma shapes of the kernel, each for T's type name TY
// ("bf16" or "f16").
#define CANAL_WGMMA_SS_N128(TY)                                              \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"        \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                 \
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "       \
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "       \
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "       \
        "%60, %61, %62, %63"                                                 \
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),   \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),   \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),   \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),   \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),   \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),   \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                 \
        : "l"(da), "l"(db), "r"(accumulate))

#define CANAL_WGMMA_SS_N64(TY)                                               \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"         \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                 \
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "       \
        "%24, %25, %26, %27, %28, %29, %30, %31"                             \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
          "+f"(d[30]), "+f"(d[31])                                           \
        : "l"(da), "l"(db), "r"(accumulate))

#define CANAL_WGMMA_RS_N64_TB(TY)                                            \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"         \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                 \
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "       \
        "%24, %25, %26, %27, %28, %29, %30, %31"                             \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                     \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
          "+f"(d[30]), "+f"(d[31])                                           \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
    if constexpr (kIsHalf<T>) CANAL_WGMMA_SS_N128("f16");
    else CANAL_WGMMA_SS_N128("bf16");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
    if constexpr (kIsHalf<T>) CANAL_WGMMA_SS_N64("f16");
    else CANAL_WGMMA_SS_N64("bf16");
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (four 16-bit
// pairs a thread), B MN-major in shared memory (the transpose bit set)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
    if constexpr (kIsHalf<T>) CANAL_WGMMA_RS_N64_TB("f16");
    else CANAL_WGMMA_RS_N64_TB("bf16");
}

#undef CANAL_WGMMA_SS_N128
#undef CANAL_WGMMA_SS_N64
#undef CANAL_WGMMA_RS_N64_TB

// Two float32 values as one pair of T, and back.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
    if constexpr (kIsHalf<T>) {
        const __half2 h = __floats2half2_rn(a, b);
        return *reinterpret_cast<const uint32_t*>(&h);
    } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        return *reinterpret_cast<const uint32_t*>(&h);
    }
}
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
    if constexpr (kIsHalf<T>)
        return __half22float2(*reinterpret_cast<const __half2*>(&u));
    else
        return __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u));
}

// p ~ hi + lo: hi = T(p), lo = T(p - hi), two columns at a time
template <typename T>
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
    hi = pack2<T>(a, b);
    const float2 hf = unpack2<T>(hi);
    lo = pack2<T>(a - hf.x, b - hf.y);
}

// Fragments (per thread of a consumer warpgroup; warp w, lane t): an
// accumulator of N columns holds, for each 8-column chunk j, rows
// r0 = 16 w + t / 4 and r1 = r0 + 8 at columns 8 j + 2 (t % 4) + {0, 1}
// in d[4 j + {0, 1}] (r0) and d[4 j + {2, 3}] (r1). The A fragment of a
// 16-key step kk is then d[8 kk .. 8 kk + 7] packed in pairs.

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// named barriers 1 and 2: warpgroup g waits on 1 + g for its turn at the
// tensor cores, and hands the turn over by arriving on the other's
__device__ __forceinline__ void turn_wait(int g) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + g), "n"(kConsumers)
                 : "memory");
}
__device__ __forceinline__ void turn_pass(int g) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(2 - g), "n"(kConsumers)
                 : "memory");
}

// S = Q K^T into sc: D / 16 steps, step kk reads 32 bytes into panel kk/4
template <typename T, int D>
__device__ __forceinline__ void start_scores(float (&sc)[TcTile<D>::kKeys / 2],
                                             uint32_t q_base,
                                             uint32_t k_base) {
    using Tile = TcTile<D>;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = smem_desc(
            q_base + (kk / 4) * Tile::kQPanel + off, 16, 1024);
        const uint64_t db = smem_desc(
            k_base + (kk / 4) * Tile::kKvPanel + off, 16, 1024);
        if constexpr (Tile::kKeys == 128)
            wgmma_ss_n128<T>(sc, da, db, kk > 0);
        else
            wgmma_ss_n64<T>(sc, da, db, kk > 0);
    }
    wgmma_commit();
}

// O += (P_hi + P_lo) V: P from registers, V MN-major, one 64-column panel
// of O at a time
template <typename T, int D>
__device__ __forceinline__ void start_pv(
        float (&acc)[D / kPanel][32],
        const uint32_t (&p_hi)[TcTile<D>::kKeys / 16][4],
        const uint32_t (&p_lo)[TcTile<D>::kKeys / 16][4], uint32_t v_base) {
    using Tile = TcTile<D>;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Tile::kKeys / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < Tile::kPanels; ++p) {
            const uint64_t db = smem_desc(
                v_base + p * Tile::kKvPanel + kk * 16 * 128,
                Tile::kKvPanel, 1024);
            wgmma_rs_n64_tb<T>(acc[p], p_hi[kk], db);
            wgmma_rs_n64_tb<T>(acc[p], p_lo[kk], db);
        }
    }
    wgmma_commit();
}

// One tile of the online softmax on the score fragment, in place: mask
// (`masked`: a diagonal or ragged tile), the running max m (of unscaled
// scores) and this thread's share of the denominator l of rows r0 and
// r1; sc becomes p = exp((s - m) scale) and alpha the factor by which
// the output rows must shrink. c = scale log2(e), so one FMA and one ex2
// make each p; maxima and sums run over four partials each.
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool masked, int row0, int kcol0,
                                             int skv, int causal, float c) {
    if (masked) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            const int qpos = row0 + ((i & 2) ? 8 : 0);
            const int kpos = kcol0 + 8 * (i / 4) + (i & 1);
            if (kpos >= skv || (causal && qpos < kpos)) sc[i] = kNegInf;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
            mx[j % 4] = fmaxf(mx[j % 4], fmaxf(sc[4 * j + 2 * r],
                                               sc[4 * j + 2 * r + 1]));
        float row_max = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
        row_max = fmaxf(row_max,
                        __shfl_xor_sync(0xffffffffu, row_max, 1));
        row_max = fmaxf(row_max,
                        __shfl_xor_sync(0xffffffffu, row_max, 2));
        const float m_new = fmaxf(m[r], row_max);
        const float neg = -m_new * c;
        alpha[r] = ex2(fmaf(m[r], c, neg));
        m[r] = m_new;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float& x = sc[4 * j + 2 * r + e];
                x = ex2(fmaf(x, c, neg));
                sum[j % 4] += x;
            }
        }
        l[r] = l[r] * alpha[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
    }
}

// Whether the tile of BK keys from k0 needs masking for warpgroup g's
// rows: ragged (keys past Skv) or, when causal, crossing the diagonal.
__device__ __forceinline__ bool k0_masked(int k0, int bk, int skv,
                                          int causal, int q0, int g) {
    return k0 + bk > skv || (causal && k0 + bk - 1 > q0 + 64 * g);
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / kPanel][32],
                                        const float (&alpha)[2]) {
#pragma unroll
    for (int p = 0; p < D / kPanel; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i >> 1) & 1];
}

template <typename T, int KSTEPS>
__device__ __forceinline__ void split_p(const float (&sc)[KSTEPS * 8],
                                        uint32_t (&p_hi)[KSTEPS][4],
                                        uint32_t (&p_lo)[KSTEPS][4]) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int a = 0; a < 4; ++a)
            split_pair<T>(sc[8 * kk + 2 * a], sc[8 * kk + 2 * a + 1],
                          p_hi[kk][a], p_lo[kk][a]);
}

// The work items of the persistent grid: (batch*head, 128-query tile)
// pairs, numbered heaviest first (the last query tiles of every head,
// then the ones before). Block b of G takes items in snake order, b and
// 2G - 1 - b of every 2G, so the blocks' causal work evens out.
struct ItemWalk {
    int b, G;
    __device__ int first() const { return b; }
    __device__ int next(int n) const {
        const int r = n % (2 * G);
        return n - r + (r < G ? 2 * G - 1 - b : 2 * G + b);
    }
};

struct Item {
    int bh, q0, kvh, n_kt;
};

template <int BK>
__device__ __forceinline__ Item item_of(int n, int n_qt, int bh_count,
                                        int hq, int hkv, int sq, int skv,
                                        int causal) {
    Item w;
    w.bh = n % bh_count;
    w.q0 = (n_qt - 1 - n / bh_count) * kTcRows;
    w.kvh = (w.bh / hq) * hkv + (w.bh % hq) / (hq / hkv);
    w.n_kt = (skv + BK - 1) / BK;
    if (causal) w.n_kt = min(w.n_kt, (min(w.q0 + kTcRows, sq) - 1) / BK + 1);
    return w;
}

// DP: the tile width (64, 128 or 256); dm <= DP the row width of q, k, v
// and out in memory (the head dim, or the wrapper's copy padded with zero
// columns to a multiple of 8): the tensor maps read columns dm..DP-1 as
// zeros, and only dm columns are stored. kFull: dm == DP, known at compile
// time, so the D 64, 128 and 256 epilogues compute no row width (a
// runtime one measured 3% slower at D 64 on an H100).
template <typename T, int DP, bool kFull>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                T* __restrict__ out, int bh_count, int hq, int hkv, int sq,
                int skv, int dm_arg, int causal, float scale) {
    static_assert(DP % kPanel == 0, "whole panels");
    const int dm = kFull ? DP : dm_arg;
    using Tile = TcTile<DP>;
    constexpr int BK = Tile::kKeys;
    constexpr int KSTEPS = BK / 16;     // 16-key steps of P V
    extern __shared__ uint8_t smem_raw[];
    const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t s_k = s_q + Tile::kQBytes;              // + stage
    const uint32_t s_v = s_k + kStages * Tile::kKvBytes;   // + stage
    // barriers: K full, K empty, V full, V empty (one per stage), Q full,
    // Q empty
    const uint32_t bars = s_v + kStages * Tile::kKvBytes;
    const uint32_t k_full = bars, k_empty = bars + 8 * kStages;
    const uint32_t v_full = bars + 16 * kStages;
    const uint32_t v_empty = bars + 24 * kStages;
    const uint32_t q_full = bars + 32 * kStages, q_empty = q_full + 8;

    const int n_qt = (sq + kTcRows - 1) / kTcRows;
    const int n_items = n_qt * bh_count;
    const ItemWalk walk{(int)blockIdx.x, (int)gridDim.x};

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(k_full + 8 * s, 1);
            mbar_init(k_empty + 8 * s, kConsumers);
            mbar_init(v_full + 8 * s, 1);
            mbar_init(v_empty + 8 * s, kConsumers);
        }
        mbar_init(q_full, 1);
        mbar_init(q_empty, kConsumers);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= kConsumers) {
        // producer: one thread starts every copy: per item its Q tile once
        // the last item's scores are done, then K before V of each tile.
        // `it` counts K/V tiles across items, so the ring runs on.
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == kConsumers) {
            int it = 0, j = 0;
            for (int n = walk.first(); n < n_items; n = walk.next(n), ++j) {
                const Item w = item_of<BK>(n, n_qt, bh_count, hq, hkv, sq,
                                           skv, causal);
                if (w.n_kt == 0) continue;
                if (j > 0) mbar_wait(q_empty, (j - 1) & 1);
                mbar_expect_tx(q_full, Tile::kQBytes);
                for (int p = 0; p < Tile::kPanels; ++p)
                    tma_load(s_q + p * Tile::kQPanel, &tm_q, q_full,
                             p * kPanel, w.q0, w.bh);
                for (int t = 0; t < w.n_kt; ++t, ++it) {
                    const int s = it % kStages;
                    const uint32_t parity = (it / kStages - 1) & 1;
                    const uint32_t off = s * Tile::kKvBytes;
                    if (it >= kStages) mbar_wait(k_empty + 8 * s, parity);
                    mbar_expect_tx(k_full + 8 * s, Tile::kKvBytes);
                    for (int p = 0; p < Tile::kPanels; ++p)
                        tma_load(s_k + off + p * Tile::kKvPanel, &tm_k,
                                 k_full + 8 * s, p * kPanel, t * BK, w.kvh);
                    if (it >= kStages) mbar_wait(v_empty + 8 * s, parity);
                    mbar_expect_tx(v_full + 8 * s, Tile::kKvBytes);
                    for (int p = 0; p < Tile::kPanels; ++p)
                        tma_load(s_v + off + p * Tile::kKvPanel, &tm_v,
                                 v_full + 8 * s, p * kPanel, t * BK, w.kvh);
                }
            }
        }
        return;
    }

    // consumers: warpgroup g owns query rows q0 + 64 g .. + 63 of each
    // item. Tile t's scores are started together with tile t-1's P V, so
    // the softmax of one tile runs while the tensor cores work on the
    // last, and the two warpgroups take turns at the tensor cores.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int col2 = 2 * (lane % 4);
    const uint32_t q_base = s_q + g * 64 * 128;
    const float c = scale * kLog2e;

    // The turns alternate 0, 1, 0, 1, ... over all tiles of all items:
    // warpgroup 1 hands the first to 0, and 0 waits once more after its
    // last item, so every arrival on a turn barrier is waited for. Every
    // item has a tile when skv > 0 and none when skv == 0.
    if (g == 1 && skv > 0) turn_pass(g);
    int it = 0, j = 0;
    for (int n = walk.first(); n < n_items; n = walk.next(n), ++j) {
        const Item w = item_of<BK>(n, n_qt, bh_count, hq, hkv, sq, skv,
                                   causal);
        const int row0 = w.q0 + 64 * g + 16 * warp + lane / 4;  // and + 8
        float acc[Tile::kPanels][32];
#pragma unroll
        for (int p = 0; p < Tile::kPanels; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
        float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
        float sc[BK / 2];
        uint32_t p_hi[KSTEPS][4], p_lo[KSTEPS][4];

        // tile 0: scores only
        if (w.n_kt > 0) {
            const int s = it % kStages;
            mbar_wait(q_full, j & 1);
            turn_wait(g);
            mbar_wait(k_full + 8 * s, (it / kStages) & 1);
            start_scores<T, DP>(sc, q_base, s_k + s * Tile::kKvBytes);
            turn_pass(g);
            wgmma_wait_all();
            fence_regs(sc);
            mbar_arrive(k_empty + 8 * s);
            softmax_tile(sc, m, l, alpha,
                         k0_masked(0, BK, skv, causal, w.q0, g), row0, col2,
                         skv, causal, c);
            split_p<T, KSTEPS>(sc, p_hi, p_lo);
        }
        for (int t = 1; t < w.n_kt; ++t) {
            const int s = (it + t) % kStages, sp = (it + t - 1) % kStages;
            turn_wait(g);
            mbar_wait(k_full + 8 * s, ((it + t) / kStages) & 1);
            start_scores<T, DP>(sc, q_base, s_k + s * Tile::kKvBytes);
            rescale<DP>(acc, alpha);
            mbar_wait(v_full + 8 * sp, ((it + t - 1) / kStages) & 1);
            start_pv<T, DP>(acc, p_hi, p_lo, s_v + sp * Tile::kKvBytes);
            turn_pass(g);
            asm volatile("wgmma.wait_group.sync.aligned %0;\n"
                         :: "n"(1) : "memory");      // the scores are in
            fence_regs(sc);
            mbar_arrive(k_empty + 8 * s);
            softmax_tile(sc, m, l, alpha,
                         k0_masked(t * BK, BK, skv, causal, w.q0, g), row0,
                         t * BK + col2, skv, causal, c);
            wgmma_wait_all();                           // and so is P V
#pragma unroll
            for (int p = 0; p < Tile::kPanels; ++p) fence_regs(acc[p]);
            fence_regs(p_hi);
            fence_regs(p_lo);
            mbar_arrive(v_empty + 8 * sp);
            split_p<T, KSTEPS>(sc, p_hi, p_lo);
        }
        if (w.n_kt > 0) {
            // every score of this item is in: the next Q may load
            const int sp = (it + w.n_kt - 1) % kStages;
            mbar_arrive(q_empty);
            rescale<DP>(acc, alpha);
            mbar_wait(v_full + 8 * sp, ((it + w.n_kt - 1) / kStages) & 1);
            start_pv<T, DP>(acc, p_hi, p_lo, s_v + sp * Tile::kKvBytes);
            wgmma_wait_all();
#pragma unroll
            for (int p = 0; p < Tile::kPanels; ++p) fence_regs(acc[p]);
            mbar_arrive(v_empty + 8 * sp);
        }
        it += w.n_kt;

#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int qpos = row0 + 8 * r;
            if (qpos >= sq) continue;
            const float den = fmaxf(l[r], 1e-30f);
            T* orow = out + ((size_t)w.bh * sq + qpos) * dm + col2;
            // dm is a multiple of 8 and col2 even: a pair is stored whole
            // or not at all
#pragma unroll
            for (int p = 0; p < Tile::kPanels; ++p)
#pragma unroll
                for (int jj = 0; jj < 8; ++jj)
                    if (p * kPanel + 8 * jj + col2 < dm)
                        *reinterpret_cast<uint32_t*>(
                            orow + p * kPanel + 8 * jj) =
                            pack2<T>(acc[p][4 * jj + 2 * r] / den,
                                     acc[p][4 * jj + 2 * r + 1] / den);
        }
    }
    if (g == 0 && skv > 0) turn_wait(g);
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA library (libcuda) the runtime has
// already loaded
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// (heads, rows, d) of T, contiguous, as a 3-D map of {64, box_rows, 1}
// boxes in the 128-byte swizzle; rows past `rows` and columns past d read
// as zeros. TMA asks for a row stride, 2 d bytes, that is a multiple of
// 16: d is a multiple of 8 (the wrapper pads q, k and v where the head
// dim is not), and for a base on 16 bytes.
template <typename T>
bool encode(CUtensorMap* map, const void* ptr, int d, int rows, int heads,
            int box_rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                                (cuuint64_t)heads};
    const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                   (cuuint64_t)rows * d * 2};
    const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return fn(map,
              kIsHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
              3,
              const_cast<void*>(ptr), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DP>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              int batch, int hq, int hkv, int sq, int skv, int dm, int d,
              int causal, cudaStream_t stream) {
    using Tile = TcTile<DP>;
    if (dm % 8 || dm > DP || d > dm) return (int)cudaErrorInvalidValue;
    CUtensorMap tm_q, tm_k, tm_v;
    // with no keys nothing is loaded from k/v: map q in their place
    const void* kp = skv > 0 ? k : q;
    const void* vp = skv > 0 ? v : q;
    const int kv_rows = skv > 0 ? skv : sq;
    const int kv_heads = skv > 0 ? batch * hkv : batch * hq;
    if (!encode<T>(&tm_q, q, dm, sq, batch * hq, kTcRows) ||
        !encode<T>(&tm_k, kp, dm, kv_rows, kv_heads, Tile::kKeys) ||
        !encode<T>(&tm_v, vp, dm, kv_rows, kv_heads, Tile::kKeys))
        return (int)cudaErrorInvalidValue;
    const auto kernel = dm == DP ? flash_tc_kernel<T, DP, true>
                                 : flash_tc_kernel<T, DP, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Tile::kSmem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, n_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return (int)err;
    // of the true head dim d: D 64 2^-3 exactly; else 1 / sqrt(d) in
    // double, then float32
    const float scale = (float)(1.0 / std::sqrt((double)d));
    // the persistent grid numbers its items with ints
    const long long n_items =
        (long long)((sq + kTcRows - 1) / kTcRows) * batch * hq;
    if (n_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int grid = (int)(n_items < n_sm ? n_items : n_sm);
    kernel<<<grid, kTcThreads, Tile::kSmem, stream>>>(
        tm_q, tm_k, tm_v, static_cast<T*>(out), batch * hq, hq, hkv, sq,
        skv, dm, causal, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (the CUDA-core kernel, at the tile width DP = d
// rounded up to 32), 1 bfloat16 or 2 float16 (the tensor-core kernel, at
// the tile width of 64, 128 or 256 that holds dm); a head dim past 256
// runs flash_wide_kernel for any of the three. d: the head dim, 1 or
// more; dm: the row width of q, k, v and out in memory (d, or for the
// tensor-core kernel d padded with zero columns to a multiple of 8 by the
// wrapper). Anything else is refused with cudaErrorInvalidValue (the
// wrapper checks first), as is a 16-bit tensor TMA cannot map (a base not
// on 16 bytes).
extern "C" int canal_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int batch,
                                     int hq, int hkv, int sq, int skv,
                                     int dm, int d, int causal, int dtype,
                                     void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (hkv < 1 || hq % hkv || d < 1 || dm < d)
        return (int)cudaErrorInvalidValue;
#define CANAL_FLASH_ARGS q, k, v, out, batch, hq, hkv, sq, skv
    if (d > 256) {
        if (dm != d) return (int)cudaErrorInvalidValue;
        switch (dtype) {
            case 0: return launch_wide<float>(CANAL_FLASH_ARGS, d, causal,
                                              st);
            case 1: return launch_wide<__nv_bfloat16>(CANAL_FLASH_ARGS, d,
                                                      causal, st);
            case 2: return launch_wide<__half>(CANAL_FLASH_ARGS, d, causal,
                                               st);
        }
        return (int)cudaErrorInvalidValue;
    }
    if (dtype == 0) {
        if (dm != d) return (int)cudaErrorInvalidValue;
        switch ((d + 31) / 32) {
            case 1: return launch_f32<32>(CANAL_FLASH_ARGS, d, causal, st);
            case 2: return launch_f32<64>(CANAL_FLASH_ARGS, d, causal, st);
            case 3: return launch_f32<96>(CANAL_FLASH_ARGS, d, causal, st);
            case 4: return launch_f32<128>(CANAL_FLASH_ARGS, d, causal, st);
            case 5: return launch_f32<160>(CANAL_FLASH_ARGS, d, causal, st);
            case 6: return launch_f32<192>(CANAL_FLASH_ARGS, d, causal, st);
            case 7: return launch_f32<224>(CANAL_FLASH_ARGS, d, causal, st);
            case 8: return launch_f32<256>(CANAL_FLASH_ARGS, d, causal, st);
        }
    } else if (dtype == 1 || dtype == 2) {
        const int width = dm <= 64 ? 64 : dm <= 128 ? 128 : 256;
#define CANAL_FLASH_TC(T)                                                    \
        switch (width) {                                                     \
            case 64:                                                         \
                return launch_tc<T, 64>(CANAL_FLASH_ARGS, dm, d, causal, st);\
            case 128:                                                        \
                return launch_tc<T, 128>(CANAL_FLASH_ARGS, dm, d, causal,    \
                                         st);                                \
            default:                                                         \
                return launch_tc<T, 256>(CANAL_FLASH_ARGS, dm, d, causal,    \
                                         st);                                \
        }
        if (dtype == 1) {
            CANAL_FLASH_TC(__nv_bfloat16)
        } else {
            CANAL_FLASH_TC(__half)
        }
#undef CANAL_FLASH_TC
    }
#undef CANAL_FLASH_ARGS
    return (int)cudaErrorInvalidValue;
}

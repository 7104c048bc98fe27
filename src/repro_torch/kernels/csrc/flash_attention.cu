// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:94
// (flash_attention, _flash_kernel) together with the GQA wrapper of
// repro/kernels/ops.py:92-106: causal (or full) softmax attention on
// q (B, Hq, Sq, D) and k/v (B, Hkv, Skv, D), output (B, Hq, Sq, D) in q's
// dtype. The reference's numbers are kept: q is cast to float32 and
// multiplied by 1/sqrt(D) before the dot; scores, the running max and the
// denominator are float32; masked scores are -1e30 (keys past Skv, and
// keys past the query position when causal, 0-based positions for both);
// the output divides by max(l, 1e-30). The Pallas version pads Sq and Skv
// to 128 for its tiling; here the ragged edges are masked instead.
//
// Design: one block per (batch*head, 64-query tile), 128 threads. The
// query tile (pre-scaled) and each 64-key K/V tile are staged through
// shared memory as float32; Q and K are stored transposed so that every
// thread reads its 4 query rows and 8 key columns as float4s. Each thread
// holds a 4 x 8 block of scores and a 4 x (D / 8) block of the output;
// the online softmax reduces each row over the 8 threads that share it
// with warp shuffles. Probabilities go through shared memory (transposed)
// for the PV product. Causal tiles wholly above the diagonal are skipped,
// and the blocks of the heaviest query tiles are launched first. For GQA
// the block reads kv head h / (Hq / Hkv) instead of a repeated copy.
//
// Bound: at the LM path's shapes (B 2, Hq 32, S 2048, D 64, causal) the
// work is ~34 GFLOP against ~38 MB of bytes, so operations bound it. This
// first version does the dot products on the CUDA cores in float32 (no
// tensor cores), so it cannot come near the bf16 tensor-core bound;
// mma/wgmma tiles are the speed work of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;    // 16 row groups (4 rows) x 8 column groups
constexpr int kLd = kBQ + 4;     // padded stride of the transposed tiles
constexpr float kNegInf = -1.0e30f;

static_assert(kBQ == kBK, "the transposed tiles share one stride");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
    // qt [D][kLd], kt [D][kLd], vs [kBK][D], pt [kBK][kLd]
    return (size_t)(2 * D * kLd + kBK * D + kBK * kLd) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
             int sq, int skv, int causal, float scale) {
    static_assert(D % 32 == 0, "head dim must be a multiple of 32");
    constexpr int DJ = D / 32;   // float4 column groups of the output
    extern __shared__ float4 smem4[];
    float* qt = reinterpret_cast<float*>(smem4);
    float* kt = qt + D * kLd;
    float* vs = kt + D * kLd;
    float* pt = vs + kBK * D;

    const int tid = threadIdx.x;
    const int tx = tid & 7;      // column group: lanes 0-7 of a row group
    const int ty = tid >> 3;     // row group: query rows ty*4 .. ty*4+3
    const int n_qt = (sq + kBQ - 1) / kBQ;
    const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;
    const int bh = blockIdx.y;
    const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
    const T* qp = q + (size_t)bh * sq * D;
    const T* kp = k + (size_t)kvh * skv * D;
    const T* vp = v + (size_t)kvh * skv * D;

    for (int i = tid; i < kBQ * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const int qr = q0 + r;
        qt[d * kLd + r] = qr < sq ? to_f(qp[(size_t)qr * D + d]) * scale
                                  : 0.f;
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
        for (int i = tid; i < kBK * D; i += kThreads) {
            const int r = i / D, d = i % D;
            const bool live = k0 + r < skv;
            const size_t g = (size_t)(k0 + r) * D + d;
            kt[d * kLd + r] = live ? to_f(kp[g]) : 0.f;
            vs[r * D + d] = live ? to_f(vp[g]) : 0.f;
        }
        __syncthreads();

        // scores: rows ty*4+i, columns tx*4+j (j < 4) and 32+tx*4+j-4
        float s[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
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
                    &vs[c * D + g * 32 + tx * 4]);
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
            for (int e = 0; e < 4; ++e)
                store(&orow[g * 32 + tx * 4 + e], acc[i][g * 4 + e] / den);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int batch, int hq, int hkv, int sq, int skv, int causal,
           cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    // the reference's scale: 1 / sqrt(D) in double, then float32
    const float scale = (float)(1.0 / std::sqrt((double)D));
    const dim3 grid((sq + kBQ - 1) / kBQ, batch * hq);
    flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv,
        causal, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; d: 64 or 128. Anything else is refused
// with cudaErrorInvalidValue (the wrapper checks first).
extern "C" int canal_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int batch,
                                     int hq, int hkv, int sq, int skv, int d,
                                     int causal, int dtype, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (hkv < 1 || hq % hkv) return (int)cudaErrorInvalidValue;
    if (dtype == 0 && d == 64)
        return launch<float, 64>(q, k, v, out, batch, hq, hkv, sq, skv,
                                 causal, st);
    if (dtype == 0 && d == 128)
        return launch<float, 128>(q, k, v, out, batch, hq, hkv, sq, skv,
                                  causal, st);
    if (dtype == 1 && d == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, out, batch, hq, hkv, sq,
                                         skv, causal, st);
    if (dtype == 1 && d == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, out, batch, hq, hkv, sq,
                                          skv, causal, st);
    return (int)cudaErrorInvalidValue;
}

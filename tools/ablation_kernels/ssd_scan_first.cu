// ssd_scan as first ported (one block per batch*head walking its chunks
// in order), kept unchanged as a baseline for
// tools/torch_kernel_ablations.py --only ssd.
// Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:96 (ssd_scan,
// _ssd_kernel): x (BH, L, P), dt (BH, L), a (BH,), b and c (BH, L, N),
// all float32, give y (BH, L, P). L is walked in chunks of C, zero-padded
// at the end (a padded dt of 0 leaves the state alone). Per chunk, as the
// reference kernel computes it:
//   seg  = cumsum(dt * a)
//   y    = (c h0^T) * exp(seg)  +  ((c b^T) * tril(exp(seg_t - seg_u))
//                                   * dt_u) x
//   h    = exp(seg_last) h0 + (x * (dt * exp(seg_last - seg)))^T b
// all in float32 on the CUDA cores (no TF32).
//
// Design: the TPU kernel carries the (P, N) state in VMEM along a
// sequential grid axis. Blocks do not run in order here, so one block of
// 256 threads owns one batch*head and walks its chunks in order, with the
// state in shared memory (transposed, N x P). A chunk's x and b (b
// transposed, N x C) sit in shared memory too; c is streamed in tiles of
// 32 state dims, which accumulate the (C x C) scores c b^T and the
// (C x P) inter-chunk term c h0^T in registers (16 x 16 threads, each an
// (C/16) x (C/16) and (C/16) x (P/16) block). The masked, decayed weights
// go through shared memory for the intra-chunk product, and each thread
// then updates a (P/16) x (N/16) block of the state. At C 128, P 64,
// N 128 that is 211 KB of shared memory, one block per SM; BH = 128 at the
// LM path's B = 2 is one wave on 132 SMs.
//
// Bound: ~10.5 MFLOP per (batch*head, chunk) against ~0.2 MB moved, so
// the float32 CUDA-core rate bounds it. With one block an SM and 8 warps,
// latency is hidden only by each thread's independent accumulators; a
// split into parallel per-chunk passes and a short carry is the speed
// work of a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kNT = 32;          // state dims of c per streamed tile

template <int C, int P, int N>
struct Layout {
    static_assert(C % 16 == 0 && P % 16 == 0 && N % 16 == 0,
                  "chunk, P and N must be multiples of 16");
    static_assert(N % kNT == 0, "N must be a multiple of the c tile");
    static constexpr int LDB = C + 1;     // bt [N][LDB]
    static constexpr int LDC = kNT + 1;   // ct [C][LDC]
    static constexpr int LDW = C + 1;     // ws [C][LDW]
    static constexpr int floats =
        N * P + C * P + N * LDB + C * LDC + C * LDW + 3 * C;
    static constexpr size_t bytes = (size_t)floats * sizeof(float);
};

template <int C, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ c, float* __restrict__ y, int L) {
    using Lay = Layout<C, P, N>;
    constexpr int LDB = Lay::LDB, LDC = Lay::LDC, LDW = Lay::LDW;
    constexpr int RT = C / 16;   // chunk rows t per thread
    constexpr int RU = C / 16;   // chunk columns u per thread
    constexpr int RP = P / 16;   // head dims p per thread
    constexpr int RN = N / 16;   // state dims n per thread
    extern __shared__ float smem[];
    float* ht = smem;               // [N][P]   carried state, transposed
    float* xs = ht + N * P;         // [C][P]   x chunk
    float* bt = xs + C * P;         // [N][LDB] b chunk, transposed
    float* ct = bt + N * LDB;       // [C][LDC] c tile (kNT state dims)
    float* ws = ct + C * LDC;       // [C][LDW] intra-chunk weights
    float* seg = ws + C * LDW;      // [C]
    float* dts = seg + C;           // [C]
    float* coef = dts + C;          // [C] dt * exp(seg_last - seg)

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const size_t bh = blockIdx.x;
    const float av = a[bh];
    x += bh * L * P;
    dt += bh * L;
    b += bh * L * N;
    c += bh * L * N;
    y += bh * L * P;

    for (int i = tid; i < N * P; i += kThreads) ht[i] = 0.f;

    for (int c0 = 0; c0 < L; c0 += C) {
        const int len = min(C, L - c0);
        __syncthreads();     // the last chunk's readers are done
        for (int i = tid; i < C * P; i += kThreads)
            xs[i] = i / P < len ? x[(size_t)c0 * P + i] : 0.f;
        for (int i = tid; i < C * N; i += kThreads) {
            const int u = i / N, n = i % N;
            bt[n * LDB + u] = u < len ? b[(size_t)c0 * N + i] : 0.f;
        }
        for (int u = tid; u < C; u += kThreads)
            dts[u] = u < len ? dt[c0 + u] : 0.f;
        __syncthreads();
        if (tid == 0) {
            float s = 0.f;
            for (int u = 0; u < C; ++u) {
                s += dts[u] * av;
                seg[u] = s;
            }
        }
        __syncthreads();
        const float seg_last = seg[C - 1];
        for (int u = tid; u < C; u += kThreads)
            coef[u] = dts[u] * expf(seg_last - seg[u]);

        // scores (t = ty + 16 i, u = tx + 16 j) and c h0^T (t, p = tx+16 j)
        float sacc[RT][RU], yacc[RT][RP];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
            for (int j = 0; j < RU; ++j) sacc[i][j] = 0.f;
#pragma unroll
            for (int j = 0; j < RP; ++j) yacc[i][j] = 0.f;
        }
        for (int n0 = 0; n0 < N; n0 += kNT) {
            __syncthreads();     // the last tile's readers are done
            for (int i = tid; i < C * kNT; i += kThreads) {
                const int t = i / kNT, nn = i % kNT;
                ct[t * LDC + nn] =
                    t < len ? c[(size_t)(c0 + t) * N + n0 + nn] : 0.f;
            }
            __syncthreads();
#pragma unroll 4
            for (int nn = 0; nn < kNT; ++nn) {
                const float* brow = bt + (n0 + nn) * LDB;
                const float* hrow = ht + (n0 + nn) * P;
                float cv[RT];
#pragma unroll
                for (int i = 0; i < RT; ++i)
                    cv[i] = ct[(ty + 16 * i) * LDC + nn];
#pragma unroll
                for (int j = 0; j < RU; ++j) {
                    const float bv = brow[tx + 16 * j];
#pragma unroll
                    for (int i = 0; i < RT; ++i)
                        sacc[i][j] = fmaf(cv[i], bv, sacc[i][j]);
                }
#pragma unroll
                for (int j = 0; j < RP; ++j) {
                    const float hv = hrow[tx + 16 * j];
#pragma unroll
                    for (int i = 0; i < RT; ++i)
                        yacc[i][j] = fmaf(cv[i], hv, yacc[i][j]);
                }
            }
        }

        // weights (scores * L) * dt_u, lower triangle; y_inter * exp(seg)
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const int t = ty + 16 * i;
            const float seg_t = seg[t];
#pragma unroll
            for (int j = 0; j < RU; ++j) {
                const int u = tx + 16 * j;
                ws[t * LDW + u] =
                    t >= u ? sacc[i][j] * expf(seg_t - seg[u]) * dts[u] : 0.f;
            }
            const float decay_in = expf(seg_t);
#pragma unroll
            for (int j = 0; j < RP; ++j) yacc[i][j] *= decay_in;
        }
        __syncthreads();

        // y_intra = w x; y = y_inter + y_intra
        float iacc[RT][RP];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < RP; ++j) iacc[i][j] = 0.f;
#pragma unroll 4
        for (int u = 0; u < C; ++u) {
            float wv[RT];
#pragma unroll
            for (int i = 0; i < RT; ++i) wv[i] = ws[(ty + 16 * i) * LDW + u];
#pragma unroll
            for (int j = 0; j < RP; ++j) {
                const float xv = xs[u * P + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < RT; ++i)
                    iacc[i][j] = fmaf(wv[i], xv, iacc[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const int t = ty + 16 * i;
            if (t < len) {
#pragma unroll
                for (int j = 0; j < RP; ++j)
                    y[(size_t)(c0 + t) * P + tx + 16 * j] =
                        yacc[i][j] + iacc[i][j];
            }
        }

        // state: h[p, n] = exp(seg_last) h[p, n] + sum_u x~[u, p] b[u, n]
        // with p = tx + 16 i, n = ty + 16 j (every reader of ht finished
        // before the barrier above)
        float hacc[RP][RN];
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) hacc[i][j] = 0.f;
#pragma unroll 4
        for (int u = 0; u < C; ++u) {
            const float cu = coef[u];
            float xv[RP];
#pragma unroll
            for (int i = 0; i < RP; ++i) xv[i] = xs[u * P + tx + 16 * i] * cu;
#pragma unroll
            for (int j = 0; j < RN; ++j) {
                const float bv = bt[(ty + 16 * j) * LDB + u];
#pragma unroll
                for (int i = 0; i < RP; ++i)
                    hacc[i][j] = fmaf(xv[i], bv, hacc[i][j]);
            }
        }
        const float decay = expf(seg_last);
#pragma unroll
        for (int j = 0; j < RN; ++j)
#pragma unroll
            for (int i = 0; i < RP; ++i) {
                float* hp = &ht[(ty + 16 * j) * P + tx + 16 * i];
                *hp = decay * *hp + hacc[i][j];
            }
    }
}

template <int C, int P, int N>
int launch(const float* x, const float* dt, const float* a, const float* b,
           const float* c, float* y, int bh, int L, cudaStream_t stream) {
    const size_t smem = Layout<C, P, N>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<C, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd_kernel<C, P, N><<<bh, kThreads, smem, stream>>>(x, dt, a, b, c, y,
                                                        L);
    return (int)cudaGetLastError();
}

}  // namespace

// (chunk, P, N) = (128, 64, 128), Mamba2's; anything else is refused
// with cudaErrorInvalidValue (the wrapper checks first). Another shape is
// one more instantiation of the template.
extern "C" int canal_ssd_scan(const float* x, const float* dt, const float* a,
                              const float* b, const float* c, float* y,
                              int bh, int L, int P, int N, int chunk,
                              void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (P == 64 && N == 128 && chunk == 128)
        return launch<128, 64, 128>(x, dt, a, b, c, y, bh, L, st);
    return (int)cudaErrorInvalidValue;
}

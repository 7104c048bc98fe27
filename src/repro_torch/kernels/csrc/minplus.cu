// Tropical (min-plus) relaxation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/minplus.py:minplus_step
// (_minplus_kernel):
//
//   out[b, j] = min(d[b, j], min_i d[b, i] + w[i, j])
//
// A min-add "GEMM" on CUDA cores: Hopper's tensor cores only multiply-add,
// so they do not apply. A block owns kTJ columns x kTB rows of d; tiles of
// w (kTI x kTJ) and d (kTB x kTI) are staged in shared memory and each
// thread keeps the running minimum of its column for kTB rows in registers
// across the i loop.
//
// Exactness: each candidate is one rounded float add and min is exact, so
// the result is bitwise that of any other summation order. Padding reads
// INF = 3e38 / 4 (the router's COARSE_INF); INF + INF stays finite, and a
// plain compare keeps it so (no fminf tricks on inf).
//
// Bound: operations. B x N x N add-and-compare pairs against N^2 + 2BN
// floats of traffic.
#include <cuda_runtime.h>

namespace {

constexpr int kTJ = 128;   // columns per block (one per thread)
constexpr int kTB = 8;     // rows of d per block
constexpr int kTI = 32;    // i-tile depth
constexpr float kInf = 3.0e38f / 4.0f;

__global__ void __launch_bounds__(kTJ)
minplus_kernel(const float* __restrict__ d, const float* __restrict__ w,
               float* __restrict__ out, int B, int N) {
    __shared__ float ws[kTI][kTJ];
    __shared__ float ds[kTB][kTI];
    const int tx = threadIdx.x;
    const int j = blockIdx.x * kTJ + tx;
    const int b0 = blockIdx.y * kTB;
    float m[kTB];
#pragma unroll
    for (int r = 0; r < kTB; ++r)
        m[r] = (b0 + r < B && j < N) ? d[(size_t)(b0 + r) * N + j] : kInf;
    for (int i0 = 0; i0 < N; i0 += kTI) {
#pragma unroll 4
        for (int ii = 0; ii < kTI; ++ii)
            ws[ii][tx] = (i0 + ii < N && j < N)
                             ? w[(size_t)(i0 + ii) * N + j] : kInf;
        for (int k = tx; k < kTB * kTI; k += kTJ) {
            const int r = k / kTI, ii = k % kTI;
            ds[r][ii] = (b0 + r < B && i0 + ii < N)
                            ? d[(size_t)(b0 + r) * N + i0 + ii] : kInf;
        }
        __syncthreads();
#pragma unroll 8
        for (int ii = 0; ii < kTI; ++ii) {
            const float wv = ws[ii][tx];
#pragma unroll
            for (int r = 0; r < kTB; ++r) {
                const float c = __fadd_rn(ds[r][ii], wv);
                m[r] = c < m[r] ? c : m[r];
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kTB; ++r)
        if (b0 + r < B && j < N) out[(size_t)(b0 + r) * N + j] = m[r];
}

}  // namespace

extern "C" int canal_minplus_step(const float* d, const float* w, float* out,
                                  int B, int N, void* stream) {
    dim3 grid((N + kTJ - 1) / kTJ, (B + kTB - 1) / kTB);
    minplus_kernel<<<grid, kTJ, 0, (cudaStream_t)stream>>>(d, w, out, B, N);
    return (int)cudaGetLastError();
}

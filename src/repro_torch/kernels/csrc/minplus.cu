// Tropical (min-plus) relaxation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/minplus.py:minplus_step
// (_minplus_kernel):
//
//   out[b, j] = min(d[b, j], min_i d[b, i] + w[i, j])
//
// A min-add "GEMM" on CUDA cores: Hopper's tensor cores only multiply-add,
// so they do not apply.
//
// Bound: at the router's shapes (B <= 32 lanes after its power-of-two
// bucketing, N = 1,024 tiles at FULL) B N^2 add-and-compare pairs against
// N^2 + 2 B N floats: 1.3 us of bytes at B 32. What holds a kernel back
// there is parallelism and latency, not the card's rates: one block per
// (128 columns, 8 rows), each thread walking all N values of i, put 32
// blocks of 128 threads on a 132-SM card (~0.1 ms).
//
// Design: the i reduction is split across the 32 warps of a block, each
// a contiguous slice of i (32 values at N = 1,024). A warp loads its
// slice's rows of w into registers at once (one coalesced read a row),
// stages its slice of d in shared memory, and keeps one running minimum
// a row in registers; the warps' minima meet in shared memory, where the
// min with d[b, j] is taken. How many rows of d a block takes trades
// blocks against reads of w (4 MB at FULL, kept in L2): the dispatch below
// takes the most rows that still put blocks on half the SMs, with two
// groups of lanes sharing each 64-byte read of w. At N 1,024 that is 128
// blocks of 1,024 threads at B 32 (16 rows, 8 MB read from L2) and 128
// at B 8 (4 rows).
//
// Exactness: each candidate is one rounded float add and min is exact, so
// the result is bitwise that of any other order of the reduction (for
// inputs without NaN, as the router's costs are; fminf is one FMNMX). The
// running minima start at +inf, and i past N is never read, so values at
// or above the router's INF = 3e38 / 4 come out as the plain version
// gives them (INF + INF stays finite).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 32;             // i slices per block
constexpr int kChunk = 32;             // i values a warp holds at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kChunk + 4;        // padded stride of a staged row
static_assert(kChunk == 32, "a lane stages one value of i");

// A lane keeps R rows of one column; the RH groups of lanes of a warp
// take RH x R rows of 32 / RH columns, so a warp's read of a row of w is
// 128 / RH bytes and the block's rows share each read. A warp stages its
// slice of d as rows of kChunk values of i (the lanes store along i, no
// bank conflict); row r of lane group h sits in slot r RH + h, so the
// groups' float4 reads of four values of i land in different banks.
template <int R, int RH>
__global__ void __launch_bounds__(kThreads)
minplus_kernel(const float* __restrict__ d, const float* __restrict__ w,
               float* __restrict__ out, int B, int N) {
    constexpr int CW = 32 / RH;            // columns a block
    constexpr int ROWS = R * RH;           // rows of d a block
    constexpr int REGION = ROWS * kLd;     // floats a warp
    // a warp's region: first its staged d, [slot][i]; then its minima,
    // [row][column]
    extern __shared__ float4 smem4[];
    float* buf = reinterpret_cast<float*>(smem4);
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int col = lane % CW, rh = lane / CW;
    const int b0 = blockIdx.y * ROWS;
    const int per = (N + kWarps - 1) / kWarps;
    const int i_lo = warp * per;
    const int i_hi = min(N, i_lo + per);
    // lanes past N read column N - 1 and store nothing
    const float* wcol = w + min((int)blockIdx.x * CW + col, N - 1);
    float* ds = buf + warp * REGION;
    const float* mine = ds + rh * kLd;     // slot r RH + rh, r = 0

    float m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = __int_as_float(0x7f800000);  // +inf
    for (int i0 = i_lo; i0 < i_hi; i0 += kChunk) {
        const int n_i = min(kChunk, i_hi - i0);
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {          // row q = h R + r
            const int slot = (q % R) * RH + q / R;
            ds[slot * kLd + lane] = b0 + q < B && lane < n_i
                                        ? d[(size_t)(b0 + q) * N + i0 + lane]
                                        : 0.f;
        }
        if (n_i == kChunk) {
            float wv[kChunk];
#pragma unroll
            for (int ii = 0; ii < kChunk; ++ii)
                wv[ii] = wcol[(size_t)(i0 + ii) * N];
            __syncwarp();
#pragma unroll
            for (int ii = 0; ii < kChunk; ii += 4)
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        mine + r * RH * kLd + ii);
                    m[r] = fminf(m[r], __fadd_rn(v.x, wv[ii]));
                    m[r] = fminf(m[r], __fadd_rn(v.y, wv[ii + 1]));
                    m[r] = fminf(m[r], __fadd_rn(v.z, wv[ii + 2]));
                    m[r] = fminf(m[r], __fadd_rn(v.w, wv[ii + 3]));
                }
        } else {
            __syncwarp();
            for (int ii = 0; ii < n_i; ++ii) {
                const float wv = wcol[(size_t)(i0 + ii) * N];
#pragma unroll
                for (int r = 0; r < R; ++r)
                    m[r] = fminf(m[r],
                                 __fadd_rn(mine[r * RH * kLd + ii], wv));
            }
        }
        __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < R; ++r) ds[(rh * R + r) * CW + col] = m[r];
    __syncthreads();
    if (threadIdx.x < ROWS * CW) {
        const int r = threadIdx.x / CW;
        const int c = threadIdx.x % CW;
        const int b = b0 + r;
        const int j = blockIdx.x * CW + c;
        if (b < B && j < N) {
            float v = d[(size_t)b * N + j];
#pragma unroll 8
            for (int k = 0; k < kWarps; ++k)
                v = fminf(v, buf[k * REGION + r * CW + c]);
            out[(size_t)b * N + j] = v;
        }
    }
}

template <int R, int RH>
int launch(const float* d, const float* w, float* out, int B, int N,
           cudaStream_t stream) {
    constexpr int CW = 32 / RH, ROWS = R * RH;
    constexpr int smem = kWarps * ROWS * kLd * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        minplus_kernel<R, RH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + CW - 1) / CW, (B + ROWS - 1) / ROWS);
    minplus_kernel<R, RH><<<grid, kThreads, smem, stream>>>(d, w, out, B, N);
    return (int)cudaGetLastError();
}

}  // namespace

// The rows of d a block takes: the most of 16, 8, 4, 2 (two row groups of
// lanes, 16 columns a block) whose grid still covers half the card's SMs,
// and at most B rounded up to a power of two; else 1 (32 columns). At
// N 1,024: 16 rows at B 32, 8 at B 16, 4 at B 8.
extern "C" int canal_minplus_step(const float* d, const float* w, float* out,
                                  int B, int N, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const long long cols = (N + 15) / 16;
    const auto fits = [&](int rows) {
        return rows < 2 * B && 2 * cols * ((B + rows - 1) / rows) >= n_sm;
    };
    if (fits(16)) return launch<8, 2>(d, w, out, B, N, st);
    if (fits(8)) return launch<4, 2>(d, w, out, B, N, st);
    if (fits(4)) return launch<2, 2>(d, w, out, B, N, st);
    if (fits(2)) return launch<1, 2>(d, w, out, B, N, st);
    return launch<1, 1>(d, w, out, B, N, st);
}

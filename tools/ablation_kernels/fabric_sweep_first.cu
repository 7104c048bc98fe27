// fabric_sweep_batch as first ported (one thread per (b, i), src read
// from global memory for every configuration), kept unchanged as a
// baseline for tools/torch_kernel_ablations.py --only sweep_batch.
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
// value: a gather with no arithmetic. The TPU kernel keeps the value
// vector resident in VMEM and streams src; here one thread owns one
// (b, i): neighbouring threads read neighbouring sel entries and write
// neighbouring outputs (coalesced), the src row and the value are
// scattered loads. src (N x F int32, 6.9 MB at the Amber FULL size) is
// shared by every configuration and stays in the 50 MB L2; a row of
// vals (345 KB at FULL) is read by the blocks of one grid row.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 65535;
constexpr int kMaxBlocksY = 65535;

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const int* __restrict__ vals, const int* __restrict__ src,
             const int* __restrict__ sel, int* __restrict__ out, int n,
             int f) {
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        out[i] = vals[src[(size_t)i * f + sel[i]]];
    }
}

__global__ void __launch_bounds__(kThreads)
sweep_batch_kernel(const int* __restrict__ vals, const int* __restrict__ src,
                   const int* __restrict__ sel, int* __restrict__ out,
                   int B, int n, int f, int v_len) {
    const int stride = gridDim.x * blockDim.x;
    for (int b = blockIdx.y; b < B; b += gridDim.y) {
        const int* v = vals + (size_t)b * v_len;
        const int* s = sel + (size_t)b * n;
        int* o = out + (size_t)b * n;
        for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
             i += stride) {
            o[i] = v[src[(size_t)i * f + s[i]]];
        }
    }
}

int blocks_for(int n) {
    int blocks = (n + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    return blocks < kMaxBlocksX ? blocks : kMaxBlocksX;
}

}  // namespace

extern "C" int canal_fabric_sweep(const int* vals, const int* src,
                                  const int* sel, int* out, int n, int f,
                                  void* stream) {
    sweep_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        vals, src, sel, out, n, f);
    return (int)cudaGetLastError();
}

extern "C" int canal_fabric_sweep_batch(const int* vals, const int* src,
                                        const int* sel, int* out, int B,
                                        int n, int f, int v_len,
                                        void* stream) {
    const int rows = B < kMaxBlocksY ? (B > 0 ? B : 1) : kMaxBlocksY;
    dim3 grid(blocks_for(n), rows);
    sweep_batch_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        vals, src, sel, out, B, n, f, v_len);
    return (int)cudaGetLastError();
}

// Per-net pin bounding boxes for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/hpwl.py:net_bboxes
// (_bbox_kernel): for every net, the masked (xmin, xmax, ymin, ymax) of
// its padded (K, 2) pin list, with masked-out pins read as +/- SENTINEL
// exactly as the reference's where(mask, x, +/-SENTINEL); a net with no
// live pin is the zero box.
//
// One warp per net: lanes stride over K, then shuffle-reduce. Bound:
// bytes (each pin and mask word is read once).
#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 1 << 20;
constexpr int kWarpsPerBlock = 8;
constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -0x7fffffff - 1;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bbox_kernel(const int* __restrict__ pins, const int* __restrict__ mask,
            int* __restrict__ out, int n, int K) {
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * kWarpsPerBlock;
    for (int net = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
         net < n; net += warps) {
        int xmin = kIntMax, xmax = kIntMin;
        int ymin = kIntMax, ymax = kIntMin;
        int live = 0;
        for (int k = lane; k < K; k += 32) {
            const size_t p = (size_t)net * K + k;
            const bool m = mask[p] > 0;
            const int x = pins[2 * p], y = pins[2 * p + 1];
            xmin = min(xmin, m ? x : kSentinel);
            xmax = max(xmax, m ? x : -kSentinel);
            ymin = min(ymin, m ? y : kSentinel);
            ymax = max(ymax, m ? y : -kSentinel);
            live |= m;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            xmin = min(xmin, __shfl_xor_sync(0xffffffffu, xmin, off));
            xmax = max(xmax, __shfl_xor_sync(0xffffffffu, xmax, off));
            ymin = min(ymin, __shfl_xor_sync(0xffffffffu, ymin, off));
            ymax = max(ymax, __shfl_xor_sync(0xffffffffu, ymax, off));
        }
        live = __any_sync(0xffffffffu, live);
        if (lane == 0) {
            int4 box = live ? make_int4(xmin, xmax, ymin, ymax)
                            : make_int4(0, 0, 0, 0);
            reinterpret_cast<int4*>(out)[net] = box;
        }
    }
}

}  // namespace

extern "C" int canal_net_bboxes(const int* pins, const int* mask, int* out,
                                int n, int K, void* stream) {
    int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    blocks = blocks < 1024 ? (blocks > 0 ? blocks : 1) : 1024;
    bbox_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        pins, mask, out, n, K);
    return (int)cudaGetLastError();
}

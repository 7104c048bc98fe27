// net_bboxes and hpwl as first ported (one warp per net, lanes striding
// over K, x and y as two 4-byte loads, a grid of at most 1,024 blocks),
// kept unchanged as the baseline chip_smoke.py times beside the
// redesigned kernels (earlier_ms).
// Per-net pin bounding boxes and half-perimeter wirelength for Hopper
// (sm_90a).
//
// Replace the Pallas TPU kernels in repro/kernels/hpwl.py:
//   canal_net_bboxes <- net_bboxes (_bbox_kernel): for every net, the
//                       masked (xmin, xmax, ymin, ymax) of its padded
//                       (K, 2) pin list; a net with no live pin is the
//                       zero box.
//   canal_hpwl       <- hpwl (_hpwl_kernel): the Eq. 2 distance term
//                       (xmax - xmin) + (ymax - ymin) of the same box;
//                       0 for a net with no live pin.
// Masked-out pins read as +/- SENTINEL exactly as the reference's
// where(mask, x, +/-SENTINEL), so a live pin beyond the sentinel behaves
// the same.
//
// One warp per net: lanes stride over K, then shuffle-reduce (the TPU
// kernel reduces a 256-net block along its lane axis). Bound: bytes
// (each pin and mask word is read once, one or four words written).
#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 1 << 20;
constexpr int kWarpsPerBlock = 8;
constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -0x7fffffff - 1;

// The warp-reduced box of one net; every lane holds the result. live is
// set when the net has at least one unmasked pin.
__device__ __forceinline__ int4 warp_box(const int* __restrict__ pins,
                                         const int* __restrict__ mask,
                                         int net, int K, int lane,
                                         int* live_out) {
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
    *live_out = __any_sync(0xffffffffu, live);
    return make_int4(xmin, xmax, ymin, ymax);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bbox_kernel(const int* __restrict__ pins, const int* __restrict__ mask,
            int* __restrict__ out, int n, int K) {
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * kWarpsPerBlock;
    for (int net = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
         net < n; net += warps) {
        int live = 0;
        const int4 box = warp_box(pins, mask, net, K, lane, &live);
        if (lane == 0) {
            reinterpret_cast<int4*>(out)[net] =
                live ? box : make_int4(0, 0, 0, 0);
        }
    }
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
hpwl_kernel(const int* __restrict__ pins, const int* __restrict__ mask,
            int* __restrict__ out, int n, int K) {
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * kWarpsPerBlock;
    for (int net = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
         net < n; net += warps) {
        int live = 0;
        const int4 b = warp_box(pins, mask, net, K, lane, &live);
        if (lane == 0) {
            // int32 wrap-around as the reference's jnp arithmetic (signed
            // overflow is undefined in C++, so the sums run in uint32)
            const unsigned w = ((unsigned)b.y - (unsigned)b.x)
                               + ((unsigned)b.w - (unsigned)b.z);
            out[net] = live ? (int)w : 0;
        }
    }
}

int grid_for(int n) {
    int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    return blocks < 1024 ? (blocks > 0 ? blocks : 1) : 1024;
}

}  // namespace

extern "C" int canal_net_bboxes(const int* pins, const int* mask, int* out,
                                int n, int K, void* stream) {
    bbox_kernel<<<grid_for(n), 32 * kWarpsPerBlock, 0,
                  (cudaStream_t)stream>>>(pins, mask, out, n, K);
    return (int)cudaGetLastError();
}

extern "C" int canal_hpwl(const int* pins, const int* mask, int* out, int n,
                          int K, void* stream) {
    hpwl_kernel<<<grid_for(n), 32 * kWarpsPerBlock, 0,
                  (cudaStream_t)stream>>>(pins, mask, out, n, K);
    return (int)cudaGetLastError();
}

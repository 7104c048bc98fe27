// Per-net pin bounding boxes and half-perimeter wirelength for Hopper
// (sm_90a).
//
// Replace the Pallas TPU kernels in repro/kernels/hpwl.py:
//   canal_net_bboxes <- net_bboxes (_bbox_kernel): for every net, the
//                       masked (xmin, xmax, ymin, ymax) of its padded
//                       (K, 2) pin list; a net with no live pin is the
//                       zero box.
//   canal_hpwl       <- hpwl (_hpwl_kernel): the Eq. 2 distance term
//                       (xmax - xmin) + (ymax - ymin) of the same box,
//                       wrapping in int32; 0 for a net with no live pin.
// Masked-out pins read as +/- SENTINEL exactly as the reference's
// where(mask, x, +/-SENTINEL), so a live pin beyond the sentinel behaves
// the same; pins past K do not exist and contribute nothing.
//
// A group of G lanes per net, G = min(32, next power of two >= K), chosen
// on the host (hpwl.box_tiles, beside the wrapper) and dispatched to a
// template: lane j of a group reads pins j, j + G, ... of its net (one
// 8-byte int2 load for x and y where pins is 8-B aligned, the mask words
// consecutive across the warp), the group shuffle-reduces at width G and
// its leader stores (one 16-byte int4 for a box). A warp holds 32 / G
// consecutive nets, so its loads and stores are contiguous runs. Each
// thread issues the loads of kUnroll nets (w, w + W, ... for the grid's W
// groups) before it reduces any, to keep enough bytes in flight, where
// the grid takes more than one pass. Where one pass covers every net (n
// small, as on the annealer's path) a shorter kernel runs: one net a
// group, 32-bit indices, the load width fixed at compile time. Shuffles
// always span the whole warp: over part of a warp they cost more than the
// whole short kernel gains. The grid is at most one wave and strides over
// the rest; one block when n is small. Both kernels share the reduction
// (reduce_group).
//
// Bound: bytes (each pin and mask word read once, four or one words
// written a net).
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 1 << 20;
constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -0x7fffffff - 1;
constexpr int kUnroll = 4;   // nets a thread loads before it reduces

struct Box {
    int xmin, xmax, ymin, ymax, live;
};

// One pin into a box: a masked-out pin reads as +/- SENTINEL.
__device__ __forceinline__ void add_pin(Box& b, int2 pin, bool live) {
    b.xmin = min(b.xmin, live ? pin.x : kSentinel);
    b.xmax = max(b.xmax, live ? pin.x : -kSentinel);
    b.ymin = min(b.ymin, live ? pin.y : kSentinel);
    b.ymax = max(b.ymax, live ? pin.y : -kSentinel);
    b.live |= live;
}

// The box of each group of G lanes, in every lane of the group, by
// shuffles. Every lane of the warp takes part: a shuffle or vote over part
// of a warp costs more.
template <int G>
__device__ __forceinline__ void reduce_group(Box& b) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
        b.xmin = min(b.xmin, __shfl_xor_sync(0xffffffffu, b.xmin, off));
        b.xmax = max(b.xmax, __shfl_xor_sync(0xffffffffu, b.xmax, off));
        b.ymin = min(b.ymin, __shfl_xor_sync(0xffffffffu, b.ymin, off));
        b.ymax = max(b.ymax, __shfl_xor_sync(0xffffffffu, b.ymax, off));
        b.live |= __shfl_xor_sync(0xffffffffu, b.live, off);
    }
}

template <class Index>
__device__ __forceinline__ int2 load_pin(const int* __restrict__ pins,
                                         Index p, bool aligned) {
    if (aligned) return __ldg(reinterpret_cast<const int2*>(pins) + p);
    return make_int2(__ldg(pins + 2 * p), __ldg(pins + 2 * p + 1));
}

struct StoreBox {
    int4* out;
    template <class Index>
    __device__ void operator()(Index net, const Box& b) const {
        out[net] = b.live ? make_int4(b.xmin, b.xmax, b.ymin, b.ymax)
                          : make_int4(0, 0, 0, 0);
    }
};

struct StoreHpwl {
    int* out;
    template <class Index>
    __device__ void operator()(Index net, const Box& b) const {
        // int32 wrap-around as the reference's jnp arithmetic (signed
        // overflow is undefined in C++, so the sums run in uint32)
        const unsigned w = ((unsigned)b.xmax - (unsigned)b.xmin)
                           + ((unsigned)b.ymax - (unsigned)b.ymin);
        out[net] = b.live ? (int)w : 0;
    }
};

// The grid stride, kUnroll nets a thread at a time: store(net, box) runs
// on each net's group leader. Every lane of a warp runs the same
// iterations (the bounds are the warp's), so the shuffles see full warps.
// Index is int where every pin index and grid position fits in it.
template <int G, class Index, class Store>
__global__ void stride_kernel(const int* __restrict__ pins,
                              const int* __restrict__ mask, int n, int K,
                              int aligned, Store store) {
    const int lane = threadIdx.x & (G - 1);
    const Index group = ((Index)blockIdx.x * blockDim.x + threadIdx.x) / G;
    const Index groups = (Index)gridDim.x * blockDim.x / G;
    const Index warp_first = group - (threadIdx.x & 31) / G;
    for (Index base = 0; warp_first + base < n; base += kUnroll * groups) {
        Box b[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            b[u] = {kIntMax, kIntMin, kIntMax, kIntMin, 0};
        }
        for (int k0 = 0; k0 < K; k0 += G) {
            const int k = k0 + lane;
            int2 pin[kUnroll];
            int m[kUnroll];
            bool ok[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const Index net = group + base + u * groups;
                ok[u] = net < n && k < K;
                const Index p = ok[u] ? net * K + k : 0;
                m[u] = ok[u] ? __ldg(mask + p) : 0;
                pin[u] = ok[u] ? load_pin(pins, p, aligned != 0)
                               : make_int2(0, 0);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                if (ok[u]) add_pin(b[u], pin[u], m[u] > 0);
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) reduce_group<G>(b[u]);
        if (lane == 0) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const Index net = group + base + u * groups;
                if (net < n) store(net, b[u]);
            }
        }
    }
}

// One pass, one net a group (n small): a warp whose nets all lie past n
// leaves at once, the rest reduce as whole warps. Aligned: one int2 load
// a pin.
template <int G, bool Aligned, class Store>
__global__ void __launch_bounds__(256)
one_pass_kernel(const int* __restrict__ pins, const int* __restrict__ mask,
                int n, int K, Store store) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if ((t & ~31) / G >= n) return;
    const int net = t / G;
    const int lane = t & (G - 1);
    Box b = {kIntMax, kIntMin, kIntMax, kIntMin, 0};
    for (int k = lane; net < n && k < K; k += G) {
        const int p = net * K + k;
        const int2 pin = Aligned ? reinterpret_cast<const int2*>(pins)[p]
                                 : make_int2(pins[2 * p], pins[2 * p + 1]);
        add_pin(b, pin, mask[p] > 0);
    }
    reduce_group<G>(b);
    if (lane == 0 && net < n) store(net, b);
}

// One pass over the nets or the grid stride (32-bit indices where they
// fit).
template <int G, class Store>
void launch_g(dim3 grid, dim3 block, cudaStream_t s, const int* pins,
              const int* mask, int n, int K, int aligned, Store store) {
    const long long groups = (long long)grid.x * block.x / G;
    const bool narrow = ((long long)n + kUnroll * groups) * K < INT_MAX;
    if (groups >= n && narrow) {
        if (aligned) {
            one_pass_kernel<G, true><<<grid, block, 0, s>>>(pins, mask, n, K,
                                                            store);
        } else {
            one_pass_kernel<G, false><<<grid, block, 0, s>>>(pins, mask, n,
                                                             K, store);
        }
    } else if (narrow) {
        stride_kernel<G, int><<<grid, block, 0, s>>>(pins, mask, n, K,
                                                     aligned, store);
    } else {
        stride_kernel<G, long long><<<grid, block, 0, s>>>(pins, mask, n, K,
                                                           aligned, store);
    }
}

template <class Store>
int launch(const int* pins, const int* mask, int n, int K, int G,
           int blocks, int threads, int aligned, void* stream,
           Store store) {
    if (threads % 32 != 0 || blocks < 1 || threads > 256) {
        return (int)cudaErrorInvalidConfiguration;
    }
    const dim3 grid(blocks), block(threads);
    cudaStream_t s = (cudaStream_t)stream;
    switch (G) {
        case 1: launch_g<1>(grid, block, s, pins, mask, n, K, aligned, store);
                break;
        case 2: launch_g<2>(grid, block, s, pins, mask, n, K, aligned, store);
                break;
        case 4: launch_g<4>(grid, block, s, pins, mask, n, K, aligned, store);
                break;
        case 8: launch_g<8>(grid, block, s, pins, mask, n, K, aligned, store);
                break;
        case 16: launch_g<16>(grid, block, s, pins, mask, n, K, aligned,
                              store);
                 break;
        case 32: launch_g<32>(grid, block, s, pins, mask, n, K, aligned,
                              store);
                 break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// G, blocks and threads come from hpwl.box_tiles; aligned: pins is 8-B
// aligned (one int2 load a pin), else two 4-B loads.
extern "C" int canal_net_bboxes(const int* pins, const int* mask, int* out,
                                int n, int K, int G, int blocks, int threads,
                                int aligned, void* stream) {
    return launch(pins, mask, n, K, G, blocks, threads, aligned, stream,
                  StoreBox{reinterpret_cast<int4*>(out)});
}

extern "C" int canal_hpwl(const int* pins, const int* mask, int* out, int n,
                          int K, int G, int blocks, int threads, int aligned,
                          void* stream) {
    return launch(pins, mask, n, K, G, blocks, threads, aligned, stream,
                  StoreHpwl{out});
}

// Fused fabric fixpoint kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels in repro/kernels/fabric_step.py:
//   canal_fabric_fused_batch  <- fabric_fused_batch (_fused_batch_kernel)
//   canal_fabric_fused_run    <- fabric_fused_run   (_fused_run_kernel)
//
// One sweep updates every node of every lane from the previous sweep's
// vector (Jacobi order; an in-place update would change values on cyclic
// configurations):
//
//   nv[i] = gather  : v[src[i, sel[i]]]          (v[N] is the zero sentinel)
//   nv[i] = hold    : v[i]                       where keep[i]
//   nv[i] = re-pin  : pin_vals[i]                where pin_mask[i]
//   nv[i] = PE ALU  : res[pe_res_idx[i]]         where pe_res_idx[i] < 2P
//
// A PE output node evaluates its PE from the gathered-and-pinned values of
// the PE's input nodes, which it recomputes from the previous vector
// itself. Every new value is then a function of the previous vector
// alone, so one grid-wide barrier per sweep suffices and no PE scratch is
// needed (the TPU kernel's "read all PE inputs before placing outputs").
//
// Memory: at the Amber FULL size one lane's vector is 86,288 int32, so
// v/nv for a lane (690 KB) exceed a block's 227 KB of shared memory. The
// double-buffered (2, B, N+1) value matrices live in device memory (3.5 MB
// at B = 5, L2-resident on a 50 MB L2) and every block walks the whole
// (B, N) index space grid-stride. The grid is one cooperative launch,
// sized to be co-resident, with grid.sync() between sweeps.
//
// Bound: bytes. Per sweep a node reads its flags, its picked source index
// and one gathered value; the least traffic of a call is the src table
// plus B x N x (sel + out) (see PERF.md).
//
// Per-lane depth: lane b runs min(depths[b], max_depth) sweeps. A lane
// that is done still reaches every grid.sync() (a return would deadlock
// the grid); it just stops swapping buffers, so its result sits in
// buffer (sweeps & 1).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct Fabric {
    // shared node / PE tables
    const int* src;         // (N, F)
    const int* keep;        // (N,)
    const int* pin_mask;    // (N,)
    const int* pe_in;       // (P, 4), sentinel N
    const int* pe_res_idx;  // (N,), 2P when not a PE output
    // per-lane programs
    const int* depths;      // (B,)
    const int* sel;         // (B, N)
    const int* op;          // (B, P)
    const int* cst;         // (B, P)
    const int* imm_mask;    // (B, P, 4)
    const int* imm_val;     // (B, P, 4)
    // scratch
    int* buf;               // (2, B, N + 1) value vectors, [N] == 0
    int* picked;            // (B, N) selected source per node
    const int* pinv;        // (B, N) pinned values
    int B, N, F, P, max_depth, word;
};

__device__ __forceinline__ int lane_sweeps(const Fabric& f, int b) {
    int d = f.depths[b];
    d = d < 0 ? 0 : d;
    return d < f.max_depth ? d : f.max_depth;
}

__device__ __forceinline__ int* lane_buf(const Fabric& f, int which, int b) {
    return f.buf + ((size_t)which * f.B + b) * (size_t)(f.N + 1);
}

// PE ALU in PE_OPS order. Wrapping ops run in uint32 (signed overflow is
// undefined in C++); >> is arithmetic; shift amounts clip to [0, 15].
__device__ __forceinline__ int32_t pe_alu(int op, int32_t a, int32_t b,
                                          int32_t c, int32_t k) {
    const uint32_t ua = (uint32_t)a, ub = (uint32_t)b;
    const int s = b < 0 ? 0 : (b > 15 ? 15 : b);
    switch (op) {
        case 0: return (int32_t)(ua + ub);                 // add
        case 1: return (int32_t)(ua - ub);                 // sub
        case 2: return (int32_t)(ua * ub);                 // mul
        case 3: return a & b;                              // and
        case 4: return a | b;                              // or
        case 5: return a ^ b;                              // xor
        case 6: return (int32_t)(ua << s);                 // shl
        case 7: return a >> s;                             // shr
        case 8: return a < b ? a : b;                      // min
        case 9: return a > b ? a : b;                      // max
        case 10: {                                         // abs(a - b)
            const uint32_t d = ua - ub;
            return (int32_t)d < 0 ? (int32_t)(0u - d) : (int32_t)d;
        }
        case 11: return (a & 1) ? b : c;                   // sel
        case 12: return k;                                 // const
        default: return a;                                 // pass
    }
}

// Node value after gather, hold and re-pin (before PE placement).
__device__ __forceinline__ int32_t gathered(const Fabric& f, const int* v,
                                            int b, int i) {
    if (i >= f.N) return 0;
    const size_t bi = (size_t)b * f.N + i;
    if (f.pin_mask[i] > 0) return f.pinv[bi];
    if (f.keep[i] > 0) return v[i];
    return v[f.picked[bi]];
}

__device__ __forceinline__ int32_t node_update(const Fabric& f, const int* v,
                                               int b, int i) {
    const int r = f.pe_res_idx[i];
    if (r >= 2 * f.P) return gathered(f, v, b, i);
    const int k = r >> 1;
    const size_t pk = (size_t)b * f.P + k;
    int32_t ins[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        ins[j] = f.imm_mask[pk * 4 + j] > 0
                     ? f.imm_val[pk * 4 + j]
                     : gathered(f, v, b, f.pe_in[k * 4 + j]);
        if (r & 1) break;                 // res1 = a & word needs a only
    }
    if (r & 1) return ins[0] & f.word;
    return pe_alu(f.op[pk], ins[0], ins[1], ins[2], f.cst[pk]) & f.word;
}

// picked[b, i] = src[i, sel[b, i]] (sweep-invariant).
__device__ void pick_sources(const Fabric& f) {
    const size_t total = (size_t)f.B * f.N;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         idx < total; idx += stride) {
        const size_t i = idx % f.N;
        f.picked[idx] = f.src[i * f.F + f.sel[idx]];
    }
}

// The fixpoint, written once for both kernels: buffer 0 holds the start
// vector of every lane; lane b's result ends in buffer (sweeps(b) & 1).
// Threads stride over the flat (lane, node) space, so the lanes' node
// updates (each a chain of dependent loads) run side by side rather than
// one lane after another in the same thread.
__device__ void fixpoint(cg::grid_group& grid, const Fabric& f) {
    const int total = f.B * f.N;
    const int stride = gridDim.x * blockDim.x;
    const int first = blockIdx.x * blockDim.x + threadIdx.x;
    for (int t = 0; t < f.max_depth; ++t) {
        const int from = t & 1;
        for (int idx = first; idx < total; idx += stride) {
            const int b = idx / f.N;
            const int i = idx - b * f.N;
            if (t < lane_sweeps(f, b))
                lane_buf(f, from ^ 1, b)[i] =
                    node_update(f, lane_buf(f, from, b), b, i);
        }
        grid.sync();
    }
}

__global__ void __launch_bounds__(kThreads)
fused_batch_kernel(Fabric f, const int* vals0, int* out) {
    cg::grid_group grid = cg::this_grid();
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t total = (size_t)f.B * (f.N + 1);
    for (size_t idx = first; idx < total; idx += stride) {
        const size_t b = idx / (f.N + 1), i = idx % (f.N + 1);
        f.buf[idx] = i < (size_t)f.N ? vals0[b * f.N + i] : 0;
        if (i == (size_t)f.N) f.buf[total + idx] = 0;
    }
    pick_sources(f);
    grid.sync();
    fixpoint(grid, f);
    for (size_t idx = first; idx < (size_t)f.B * f.N; idx += stride) {
        const int b = (int)(idx / f.N);
        const int i = (int)(idx % f.N);
        out[idx] = lane_buf(f, lane_sweeps(f, b) & 1, b)[i];
    }
}

struct Stream {
    const int* ext;         // (B, T, n_io)
    const int* pin_src;     // (N,) node -> state slot
    const int* reg_src;     // (R,)
    const int* mem_in;      // (M,)
    const int* io_out;      // (n_io,)
    int* obs;               // (B, T, n_io)
    int* pinv;              // (B, N)
    int* state;             // (B, S): [regs | io | mem | 0]
    int T, n_reg, n_io, n_mem;
};

__global__ void __launch_bounds__(kThreads)
fused_run_kernel(Fabric f, Stream s) {
    cg::grid_group grid = cg::this_grid();
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int S = s.n_reg + s.n_io + s.n_mem + 1;
    // state starts at zero with cycle 0's stimulus in the io slots; the
    // sentinel entries of both value buffers are zero for good
    for (size_t idx = first; idx < (size_t)f.B * S; idx += stride) {
        const int b = (int)(idx / S), k = (int)(idx % S);
        const int j = k - s.n_reg;
        s.state[idx] = (j >= 0 && j < s.n_io)
                           ? s.ext[(size_t)b * s.T * s.n_io + j] : 0;
    }
    for (size_t b = first; b < (size_t)f.B; b += stride) {
        lane_buf(f, 0, (int)b)[f.N] = 0;
        lane_buf(f, 1, (int)b)[f.N] = 0;
    }
    pick_sources(f);
    grid.sync();
    for (int c = 0; c < s.T; ++c) {
        // each cycle starts from the pinned sources on a zero background
        for (size_t idx = first; idx < (size_t)f.B * f.N; idx += stride) {
            const int b = (int)(idx / f.N);
            const int i = (int)(idx % f.N);
            const int pv = f.pin_mask[i] > 0
                               ? s.state[(size_t)b * S + s.pin_src[i]] : 0;
            s.pinv[idx] = pv;
            lane_buf(f, 0, b)[i] = pv;
        }
        grid.sync();
        fixpoint(grid, f);
        // observe, then clock registers / memories and load the next
        // cycle's stimulus
        for (size_t idx = first; idx < (size_t)f.B * S; idx += stride) {
            const int b = (int)(idx / S), k = (int)(idx % S);
            const int* v = lane_buf(f, lane_sweeps(f, b) & 1, b);
            const int j = k - s.n_reg, m = k - s.n_reg - s.n_io;
            if (k < s.n_reg) {
                s.state[idx] = v[s.reg_src[k]];
            } else if (j < s.n_io) {
                s.obs[((size_t)b * s.T + c) * s.n_io + j] = v[s.io_out[j]];
                if (c + 1 < s.T)
                    s.state[idx] =
                        s.ext[((size_t)b * s.T + c + 1) * s.n_io + j];
            } else if (m < s.n_mem) {
                s.state[idx] = v[s.mem_in[m]];
            }
        }
        grid.sync();
    }
}

template <typename Kernel>
int cooperative_grid(Kernel kernel, size_t work, int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    size_t want = (work + kThreads - 1) / kThreads;
    size_t cap = (size_t)sms * (size_t)per_sm;
    *blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
    return 0;
}

Fabric make_fabric(const int* depths, const int* sel, const int* op,
                   const int* cst, const int* imm_mask, const int* imm_val,
                   const int* src, const int* keep, const int* pin_mask,
                   const int* pe_in, const int* pe_res_idx, int* buf,
                   int* picked, const int* pinv, int B, int N, int F, int P,
                   int max_depth, int word) {
    Fabric f;
    f.src = src; f.keep = keep; f.pin_mask = pin_mask; f.pe_in = pe_in;
    f.pe_res_idx = pe_res_idx; f.depths = depths; f.sel = sel; f.op = op;
    f.cst = cst; f.imm_mask = imm_mask; f.imm_val = imm_val; f.buf = buf;
    f.picked = picked; f.pinv = pinv; f.B = B; f.N = N; f.F = F; f.P = P;
    f.max_depth = max_depth; f.word = word;
    return f;
}

}  // namespace

extern "C" int canal_fabric_fused_batch(
    const int* depths, const int* vals0, const int* sel, const int* pin_vals,
    const int* op, const int* cst, const int* imm_mask, const int* imm_val,
    const int* src, const int* keep, const int* pin_mask, const int* pe_in,
    const int* pe_res_idx, int* out, int* buf, int* picked, int B, int N,
    int F, int P, int max_depth, int word, void* stream) {
    Fabric f = make_fabric(depths, sel, op, cst, imm_mask, imm_val, src, keep,
                           pin_mask, pe_in, pe_res_idx, buf, picked, pin_vals,
                           B, N, F, P, max_depth, word);
    int blocks = 0;
    int err = cooperative_grid(fused_batch_kernel,
                               (size_t)B * (N + 1), &blocks);
    if (err) return err;
    void* args[] = {&f, &vals0, &out};
    cudaLaunchCooperativeKernel((void*)fused_batch_kernel, dim3(blocks),
                                dim3(kThreads), args, 0,
                                (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

extern "C" int canal_fabric_fused_run(
    const int* depths, const int* sel, const int* op, const int* cst,
    const int* imm_mask, const int* imm_val, const int* ext, const int* src,
    const int* keep, const int* pin_mask, const int* pin_src,
    const int* pe_in, const int* pe_res_idx, const int* reg_src,
    const int* mem_in, const int* io_out, int* obs, int* buf, int* picked,
    int* pinv, int* state, int B, int N, int F, int P, int T, int n_reg,
    int n_io, int n_mem, int max_depth, int word, void* stream) {
    Fabric f = make_fabric(depths, sel, op, cst, imm_mask, imm_val, src, keep,
                           pin_mask, pe_in, pe_res_idx, buf, picked, pinv,
                           B, N, F, P, max_depth, word);
    Stream s;
    s.ext = ext; s.pin_src = pin_src; s.reg_src = reg_src; s.mem_in = mem_in;
    s.io_out = io_out; s.obs = obs; s.pinv = pinv; s.state = state; s.T = T;
    s.n_reg = n_reg; s.n_io = n_io; s.n_mem = n_mem;
    int blocks = 0;
    int err = cooperative_grid(fused_run_kernel, (size_t)B * (N + 1),
                               &blocks);
    if (err) return err;
    void* args[] = {&f, &s};
    cudaLaunchCooperativeKernel((void*)fused_run_kernel, dim3(blocks),
                                dim3(kThreads), args, 0,
                                (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

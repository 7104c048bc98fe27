// The PE ALU of the fabric kernels (fabric_step.cu, rv_sweeps.cu).
#pragma once
#include <stdint.h>

namespace {

// PE ALU in PE_OPS order; any other op passes a through (res1 is op -1).
// Wrapping ops run in uint32 (signed overflow is undefined in C++); >> is
// arithmetic; shift amounts clip to [0, 15]. Every
// op is computed and the result selected, with no branch: the PEs of one
// warp run different ops, and a switch would run them one after another.
// With kPred (a PE with the 1-bit inputs p0 = bit0, p1 = bit1), ops 14-18
// (PRED_OPS) too: unsigned compares, then bit0 ? a : b and bit0 & bit1.
// Without it the ALU is the 14 ops alone, so that the PEs without 1-bit
// inputs run what they ran before those ops existed.
template <bool kPred = false>
__device__ __forceinline__ int32_t pe_alu(int op, int32_t a, int32_t b,
                                          int32_t c, int32_t p0, int32_t p1,
                                          int32_t k) {
    const uint32_t ua = (uint32_t)a, ub = (uint32_t)b;
    const int s = b < 0 ? 0 : (b > 15 ? 15 : b);
    const uint32_t d = ua - ub;
    int32_t r = a;                                          // pass
    r = op == 0 ? (int32_t)(ua + ub) : r;                   // add
    r = op == 1 ? (int32_t)d : r;                           // sub
    r = op == 2 ? (int32_t)(ua * ub) : r;                   // mul
    r = op == 3 ? (a & b) : r;                              // and
    r = op == 4 ? (a | b) : r;                              // or
    r = op == 5 ? (a ^ b) : r;                              // xor
    r = op == 6 ? (int32_t)(ua << s) : r;                   // shl
    r = op == 7 ? (a >> s) : r;                             // shr
    r = op == 8 ? (a < b ? a : b) : r;                      // min
    r = op == 9 ? (a > b ? a : b) : r;                      // max
    r = op == 10 ? ((int32_t)d < 0 ? (int32_t)(0u - d) : (int32_t)d)
                 : r;                                       // abs(a - b)
    r = op == 11 ? ((a & 1) ? b : c) : r;                   // sel
    r = op == 12 ? k : r;                                   // const
    if (kPred) {
        r = op == 14 ? (int32_t)(ua > ub) : r;              // ugt
        r = op == 15 ? (int32_t)(ua >= ub) : r;             // uge
        r = op == 16 ? (int32_t)(ua < ub) : r;              // ult
        r = op == 17 ? ((p0 & 1) ? a : b) : r;              // psel
        r = op == 18 ? (p0 & p1 & 1) : r;                   // pand
    }
    return r;
}

}  // namespace

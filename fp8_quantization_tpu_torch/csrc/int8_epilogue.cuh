// Shared device code of the port's int8 Hopper kernels: the asymmetric
// input quant and the symmetric weight quant done while a tile is staged,
// the exact-integer correction epilogue of the recentred identity
//
//   sum (xint - zp) * wint = dot(xs, wsg) + S_w * rowsum(xs)
//                          + (128 - zp) * colsum(wsg) + K * (128 - zp) * S_w
//
// with xs = xint - 128, wsg = wint - S_w and S_w = 128 * (1 - signed).
//
// Replaces the quant and correction steps of _qmatmul_int8_kernel
// (fp8_quantization_tpu/ops/pallas/qmatmul.py:212-279) and
// _qconv3x3_int8_kernel (ops/pallas/qconv.py:278-363).  The Pallas kernels
// add the corrections in f32 scratch; here dot, rowsum and colsum are int32
// and the total is formed in int64, converted to float once, then scaled by
// (dx * max(dw, 1e-8)), scale and shift and the activation in that order.
// That is the plain versions' order (ops/kernels/qmatmul_int8.py and
// qconv_int8.py), so a kernel equals its plain version exactly.  Built with
// -fmad=false and _rn intrinsics, as the FP8 kernels are.  Last, the
// cp.async / ldmatrix / mma.sync s8 pieces both kernels' products use.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace i8 {

enum Activation { kActNone = 0, kActRelu = 1, kActRelu6 = 2 };

// Scalars of one launch, read from the device arrays
// a_scalars = [dx, zero_float, 0] and w_scalars = [0, signed].
struct Params {
  float dx;      // max(dx, 1e-8)
  float zpf;     // clip(round(zero_float), 0, 2^a - 1)
  float qmax;    // 2^a - 1
  float wmin;    // -2^(b-1) signed, 0 unsigned
  float wmax;    // 2^(b-1) - 1 signed, 2^b - 1 unsigned
  int zp, s_w;   // zero point; 128 * (1 - signed)
};

__device__ __forceinline__ Params load_params(const float* a_scalars,
                                              const float* w_scalars,
                                              int a_bits, int w_bits) {
  Params p;
  p.dx = fmaxf(a_scalars[0], 1e-8f);
  p.qmax = static_cast<float>((1 << a_bits) - 1);
  p.zpf = fminf(fmaxf(rintf(a_scalars[1]), 0.0f), p.qmax);
  p.zp = static_cast<int>(p.zpf);
  const float signed_ = w_scalars[1];
  p.s_w = static_cast<int>(__fmul_rn(128.0f, __fsub_rn(1.0f, signed_)));
  p.wmin = signed_ > 0.0f ? -static_cast<float>(1 << (w_bits - 1)) : 0.0f;
  p.wmax = static_cast<float>(signed_ > 0.0f ? (1 << (w_bits - 1)) - 1
                                             : (1 << w_bits) - 1);
  return p;
}

// xs = clip(round(x / dx) + zp, 0, 2^a - 1) - 128.  A zero input skips the
// division: __fdiv_rn leaves its fast path for a zero numerator, and every
// 3x3 conv input of ResNet-18 follows a relu (measured: PERF.md).
__device__ __forceinline__ int quant_x(float x, const Params& p) {
  const float q = x == 0.0f ? 0.0f : __fdiv_rn(x, p.dx);
  const float xi = fminf(fmaxf(__fadd_rn(rintf(q), p.zpf), 0.0f), p.qmax);
  return static_cast<int>(xi) - 128;
}

// wsg = clip(round(w / dw), wmin, wmax) - S_w, dw already max(dw, 1e-8)
__device__ __forceinline__ int quant_w(float w, float dw, const Params& p) {
  const float wi = fminf(fmaxf(rintf(__fdiv_rn(w, dw)), p.wmin), p.wmax);
  return static_cast<int>(wi) - p.s_w;
}

__device__ __forceinline__ float apply_act(float y, int activation) {
  if (activation == kActRelu) return fmaxf(y, 0.0f);
  if (activation == kActRelu6) return fminf(fmaxf(y, 0.0f), 6.0f);
  return y;
}

// The exact total of one output, then the float epilogue.
__device__ __forceinline__ float epilogue(int acc, int rowsum, int colsum,
                                          int K, const Params& p, float dw,
                                          float scale, float shift,
                                          int activation) {
  const long long c = 128 - p.zp;
  const long long total = static_cast<long long>(acc) +
                          static_cast<long long>(p.s_w) * rowsum +
                          c * colsum + static_cast<long long>(K) * c * p.s_w;
  float y = __fmul_rn(__ll2float_rn(total), __fmul_rn(p.dx, dw));
  y = __fadd_rn(__fmul_rn(y, scale), shift);
  return apply_act(y, activation);
}

// ---------------------------------------------------------------------------
// Warp-level pieces of the s8 kernels (qconv_int8.cu, qmatmul_int8.cu):
// 16-byte cp.async, ldmatrix and mma.sync.m16n8k32 s8 x s8 -> s32.  An s8
// operand chunk of 32 k sits in shared memory as two planes of 16 bytes
// ([plane][row][16]), so that eight rows of a plane are 128 contiguous
// bytes and ldmatrix.x4 reads a 16 x 32 A fragment (lanes 0-15: rows
// 0-15 of plane 0, lanes 16-31: of plane 1) or two 8-column B fragments
// without bank conflicts.

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// The same through L1 (.ca): for a small operand that every block on an SM
// reads again, such as the quant-matmul's baked weights.
__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c (16 x 8 s32) += a (16 x 32 s8) * b (32 x 8 s8): c0, c1 are row l/4,
// columns 2(l%4) and + 1; c2, c3 the same columns of row l/4 + 8.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xFF) |
         ((static_cast<uint32_t>(b) & 0xFF) << 8) |
         ((static_cast<uint32_t>(c) & 0xFF) << 16) |
         (static_cast<uint32_t>(d) << 24);
}

}  // namespace i8

// Shared device code of the port's Hopper kernels: the FP8 and integer tile
// quantizers and the fused epilogue.
//
// Replaces the shared Pallas tile functions of
// fp8_quantization_tpu/ops/pallas/qmatmul.py (_fp8_quantize_tile,
// _fp8_channel_factor, _int_sym_quantize_tile, _int_asym_quantize_tile,
// lines 72-142) and the conv epilogue of ops/pallas/qconv.py
// (_conv_epilogue, line 111).  The TPU tiles pick the FP8 bin with log2 +
// floor; here the bin comes from the IEEE exponent field, read exactly (as
// the JAX package's composed path does, ops/fp8.py:86-102), and rounding is
// half to even (rintf, as jnp.round and torch.round).
//
// A quantizer's scalar algebra is computed once on the host side and
// arrives as a (6, C) float array, one column per channel (C = 1 per
// tensor), six rows whose meaning depends on the method (enum QuantMethod):
//
//   fp8      lo, hi, bias_int, bias_frac_pow2, g, factor
//            (fp8_quantization_tpu_torch/ops/fp8.py:fp8_consts)
//   int_asym delta, zp, 0, 2^n - 1, 0, factor
//   int_sym  delta, 0, int_min, int_max, 0, factor
//            (fp8_quantization_tpu_torch/ops/uniform.py:int_consts)
//
// For the integer methods delta is the step floored at 1e-8, zp the zero
// point already rounded and clipped to the grid, and factor the normalized
// grid's factor (the step).  Row 5 is the factor for every method.  The
// kernels are built with -fmad=false and use the _rn intrinsics, so no
// multiply-add is contracted and every value matches the plain PyTorch
// version's arithmetic step by step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fq {

enum Activation { kActNone = 0, kActRelu = 1, kActRelu6 = 2 };

// Quantizer codes (ops/kernels/common.py:QUANT_CODES).  The two integer
// methods run one device function (their constants carry the grid) but
// keep their own codes: one shared code made nvcc give qmatmul more
// registers a thread and run 1.3-1.6x slower (PERF.md, section 6).
enum QuantMethod { kQuantNone = 0, kQuantFp8 = 1, kQuantIntAsym = 2,
                   kQuantIntSym = 3 };

// One column of a (6, C) constant array, rows as in the header note.
struct QuantConsts {
  float r[6];
  __device__ __forceinline__ float factor() const { return r[5]; }
};

// Column idx of a (6, C) constant array (C = stride).
__device__ __forceinline__ QuantConsts load_consts(const float* c, int stride,
                                                   int idx) {
  QuantConsts k;
#pragma unroll
  for (int i = 0; i < 6; ++i) k.r[i] = c[i * stride + idx];
  return k;
}

// FP8 fake-quant of one value.  normalized: the value on the pure binary
// grid (an (M+1)-bit significand times a power of two, exact in bf16);
// otherwise the full-scale value (normalized value times the factor).
__device__ __forceinline__ float fq_quantize(float x, const QuantConsts& k,
                                             bool normalized) {
  const float xc = fminf(fmaxf(x, k.r[0]), k.r[1]);
  const float y = __fmul_rn(fabsf(xc), k.r[3]);
  const int e = ((__float_as_int(y) >> 23) & 0xFF) - 127;
  const float ls = fmaxf(__fadd_rn(static_cast<float>(e), k.r[2]), 1.0f);
  const float p = fminf(fmaxf(__fadd_rn(ls, k.r[4]), -126.0f), 127.0f);
  const float pow2 = __int_as_float((static_cast<int>(p) + 127) << 23);
  const float scale = __fmul_rn(pow2, k.factor());
  const float m = rintf(__fdiv_rn(xc, scale));
  return normalized ? __fmul_rn(m, pow2) : __fmul_rn(m, scale);
}

// Uniform (INT) fake-quant of one value, asymmetric or symmetric:
// xint = clip(rint(x / delta) + zp, lo, hi), then xint - zp (normalized: an
// integer of at most 8 bits for an 8-bit grid, exact in bf16) or
// (xint - zp) * delta.  An IEEE division, as the Pallas tiles and the
// plain version divide.
__device__ __forceinline__ float int_quantize(float x, const QuantConsts& k,
                                              bool normalized) {
  const float delta = k.r[0], zp = k.r[1];
  const float xi = fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(x, delta)), zp),
                               k.r[2]), k.r[3]);
  const float q = __fsub_rn(xi, zp);
  return normalized ? q : __fmul_rn(q, delta);
}

// Fake-quant of one value by the quantizer of code ``method``.
__device__ __forceinline__ float quantize(float x, int method,
                                          const QuantConsts& k,
                                          bool normalized) {
  if (method == kQuantFp8) return fq_quantize(x, k, normalized);
  if (method == kQuantIntAsym || method == kQuantIntSym)
    return int_quantize(x, k, normalized);
  return x;
}

// A quantizer with the reciprocal of its divisor computed once: the FP8
// grid divides x by factor * 2^p, the integer grids by delta.  Dividing by
// 2^p is an exact scaling, and RN(a / d) comes from inv = RN(1 / d) by one
// Newton step, q = RN(a * inv), r = a - q * d (exact, fused), RN(q + r *
// inv) (Markstein's theorem: correctly rounded when inv is, barring
// overflow and underflow), so quantize_inv returns quantize()'s values
// without an IEEE division per value.  Used by the block kernel, where the
// quantizers of the expanded and filtered tensors run on every
// intermediate value (qblock.cu), and by the epilogues of the 3x3, the
// depthwise and the stem kernels.
struct InvQuant {
  QuantConsts k;
  float inv;
  int method;
  int bias_int, g;      // FP8: rows 2 and 4, integers, as ints
};

__device__ __forceinline__ InvQuant make_inv_quant(int method,
                                                   const QuantConsts& k) {
  InvQuant q{k, 1.0f, method, static_cast<int>(k.r[2]),
             static_cast<int>(k.r[4])};
  if (method == kQuantFp8) q.inv = __fdiv_rn(1.0f, k.factor());
  if (method == kQuantIntAsym || method == kQuantIntSym)
    q.inv = __fdiv_rn(1.0f, k.r[0]);
  return q;
}

// RN(a / d), given inv = RN(1 / d)
__device__ __forceinline__ float div_inv(float a, float d, float inv) {
  const float q = __fmul_rn(a, inv);
  return __fmaf_rn(__fmaf_rn(-q, d, a), inv, q);
}

// quantize_inv for a method known at compile time (M = kQuantIntAsym
// serves both integer methods): straight-line code that the compiler can
// interleave across values.
template <int M>
__device__ __forceinline__ float quantize_inv_m(float x, const InvQuant& q,
                                                bool normalized) {
  const QuantConsts& k = q.k;
  if constexpr (M == kQuantFp8) {
    // fq_quantize's bin in integers (bias_int and g are whole numbers)
    const float xc = fminf(fmaxf(x, k.r[0]), k.r[1]);
    const float y = __fmul_rn(fabsf(xc), k.r[3]);
    const int e = ((__float_as_int(y) >> 23) & 0xFF) - 127;
    const int pi = min(max(max(e + q.bias_int, 1) + q.g, -126), 127);
    const float pow2 = __int_as_float((pi + 127) << 23);
    const float scale = __fmul_rn(pow2, k.factor());
    // xc / 2^p, exact (2^-p is normal up to p = 126; at p = 127 a second
    // halving can round only where |xc / scale| is far below 1/2)
    float t = __fmul_rn(xc, __int_as_float((127 - min(pi, 126)) << 23));
    if (pi == 127) t = __fmul_rn(t, 0.5f);
    const float m = rintf(div_inv(t, k.factor(), q.inv));
    return normalized ? __fmul_rn(m, pow2) : __fmul_rn(m, scale);
  } else if constexpr (M == kQuantIntAsym) {
    const float delta = k.r[0], zp = k.r[1];
    const float xi = fminf(fmaxf(__fadd_rn(rintf(div_inv(x, delta, q.inv)), zp),
                                 k.r[2]), k.r[3]);
    const float v = __fsub_rn(xi, zp);
    return normalized ? v : __fmul_rn(v, delta);
  } else {
    return x;
  }
}

__device__ __forceinline__ float quantize_inv(float x, const InvQuant& q,
                                              bool normalized) {
  if (q.method == kQuantFp8) return quantize_inv_m<kQuantFp8>(x, q, normalized);
  if (q.method == kQuantIntAsym || q.method == kQuantIntSym)
    return quantize_inv_m<kQuantIntAsym>(x, q, normalized);
  return x;
}

__device__ __forceinline__ float apply_act(float y, int activation) {
  if (activation == kActRelu) return fmaxf(y, 0.0f);
  if (activation == kActRelu6) return fminf(fmaxf(y, 0.0f), 6.0f);
  return y;
}

// y*scale + shift [+ residual], activation, the output quant of code
// ``method`` (kQuantNone: none).
__device__ __forceinline__ float epilogue(float y, float scale, float shift,
                                          bool has_res, float res,
                                          int activation, int method,
                                          const QuantConsts& a,
                                          bool emit_norm) {
  y = __fadd_rn(__fmul_rn(y, scale), shift);
  if (has_res) y = __fadd_rn(y, res);
  y = apply_act(y, activation);
  return quantize(y, method, a, emit_norm);
}

__device__ __forceinline__ void store_out(void* out, long long i, float y,
                                          bool bf16_out) {
  if (bf16_out)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(out)[i] = y;
}

}  // namespace fq

// Shared device code of the port's Hopper kernels: the FP8 tile quantizer,
// the fused epilogue and the bf16 tensor-core tile product.
//
// Replaces the shared Pallas tile functions of
// fp8_quantization_tpu/ops/pallas/qmatmul.py (_fp8_quantize_tile,
// _fp8_channel_factor, lines 72-105) and the conv epilogue of
// ops/pallas/qconv.py (_conv_epilogue, line 111).  The TPU tiles pick the
// FP8 bin with log2 + floor; here the bin comes from the IEEE exponent
// field, read exactly (as the JAX package's composed path does,
// ops/fp8.py:86-102), and rounding is half to even (rintf).
//
// The quantizer's scalar algebra (bias, its fractional power of two, the
// exponent offset g and the channel factor) is computed once on the host
// side by fp8_quantization_tpu_torch/ops/fp8.py:fp8_consts and arrives as
// a (6, C) float array, rows in the order of struct Fp8Consts.  The kernels
// are built with -fmad=false and use the _rn intrinsics, so no multiply-add
// is contracted and every value matches the plain PyTorch version's
// arithmetic step by step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace fq {

enum Activation { kActNone = 0, kActRelu = 1, kActRelu6 = 2 };

struct Fp8Consts {
  float lo, hi, bias_int, bias_frac_pow2, g, factor;
};

// Column idx of a (6, C) constant array (C = stride).
__device__ __forceinline__ Fp8Consts load_consts(const float* c, int stride,
                                                 int idx) {
  Fp8Consts k;
  k.lo = c[idx];
  k.hi = c[stride + idx];
  k.bias_int = c[2 * stride + idx];
  k.bias_frac_pow2 = c[3 * stride + idx];
  k.g = c[4 * stride + idx];
  k.factor = c[5 * stride + idx];
  return k;
}

// FP8 fake-quant of one value.  normalized: the value on the pure binary
// grid (an (M+1)-bit significand times a power of two, exact in bf16);
// otherwise the full-scale value (normalized value times k.factor).
__device__ __forceinline__ float fq_quantize(float x, const Fp8Consts& k,
                                             bool normalized) {
  const float xc = fminf(fmaxf(x, k.lo), k.hi);
  const float y = __fmul_rn(fabsf(xc), k.bias_frac_pow2);
  const int e = ((__float_as_int(y) >> 23) & 0xFF) - 127;
  const float ls = fmaxf(__fadd_rn(static_cast<float>(e), k.bias_int), 1.0f);
  const float p = fminf(fmaxf(__fadd_rn(ls, k.g), -126.0f), 127.0f);
  const float pow2 = __int_as_float((static_cast<int>(p) + 127) << 23);
  const float scale = __fmul_rn(pow2, k.factor);
  const float m = rintf(__fdiv_rn(xc, scale));
  return normalized ? __fmul_rn(m, pow2) : __fmul_rn(m, scale);
}

__device__ __forceinline__ float apply_act(float y, int activation) {
  if (activation == kActRelu) return fmaxf(y, 0.0f);
  if (activation == kActRelu6) return fminf(fmaxf(y, 0.0f), 6.0f);
  return y;
}

// y*scale + shift [+ residual], activation, optional output FP8 quant.
__device__ __forceinline__ float epilogue(float y, float scale, float shift,
                                          bool has_res, float res,
                                          int activation, bool act_fp8,
                                          const Fp8Consts& a, bool emit_norm) {
  y = __fadd_rn(__fmul_rn(y, scale), shift);
  if (has_res) y = __fadd_rn(y, res);
  y = apply_act(y, activation);
  if (act_fp8) y = fq_quantize(y, a, emit_norm);
  return y;
}

__device__ __forceinline__ void store_out(void* out, long long i, float y,
                                          bool bf16_out) {
  if (bf16_out)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(out)[i] = y;
}

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// 64x64 output tile, K in chunks of 32, four warps each owning a 32x32
// quarter as 2x2 wmma 16x16x16 bf16 fragments with fp32 accumulators.
// The caller stages one chunk of A (BM x BK, row-major) and B (BK x BN,
// row-major) into shared memory, syncs, calls mma_chunk, syncs again.
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;

struct __align__(128) GemmSmem {
  __nv_bfloat16 a[BM * LDA];
  __nv_bfloat16 b[BK * LDB];
  float c[BM * LDC];
};

using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                       float>;

__device__ __forceinline__ void zero_acc(AccFrag (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
}

__device__ __forceinline__ void mma_chunk(const GemmSmem& s,
                                          AccFrag (&acc)[2][2], int warp) {
  using namespace nvcuda;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], s.a + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], s.b + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_acc(GemmSmem& s, AccFrag (&acc)[2][2],
                                          int warp) {
  using namespace nvcuda;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s.c + (wm + 16 * i) * LDC + wn + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
}

}  // namespace fq

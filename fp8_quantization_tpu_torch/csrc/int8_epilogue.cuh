// Shared device code of the port's int8 Hopper kernels: the asymmetric
// input quant and the symmetric weight quant done while a tile is staged,
// the s8 x s8 -> s32 tensor-core tile product, and the exact-integer
// correction epilogue of the recentred identity
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
// -fmad=false and _rn intrinsics, as the FP8 kernels are.
#pragma once

#include <cuda_runtime.h>
#include <mma.h>
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
// 64x64 output tile, K in chunks of 64, 128 threads.  Shared memory holds
// each operand chunk as four planes of 16 k (plane[kk/16][row][16]), so
// that every wmma fragment starts on a 32-byte boundary with a leading
// dimension of 16 bytes.  Thread t stages row (or column) t / 2, k from
// 32 * (t % 2): two runs of 16 values, one per plane.  Each of the four
// warps owns a 32x32 quarter as 2x2 wmma 16x16x16 s8 fragments with int32
// accumulators.
constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128, RUN = 16;
constexpr int PLANES = BK / RUN, LDC = BN + 4;

struct __align__(128) Smem {
  int8_t a[PLANES][BM][RUN];
  int8_t b[PLANES][BN][RUN];
  int c[BM * LDC];
  int rowsum[BM];
  int colsum[BN];
};

// Store one run of 16 int8 values (in registers as ints) into a plane.
__device__ __forceinline__ void put_run(int8_t* dst, const int (&v)[RUN]) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = (static_cast<uint32_t>(v[4 * q] & 0xFF)) |
           (static_cast<uint32_t>(v[4 * q + 1] & 0xFF) << 8) |
           (static_cast<uint32_t>(v[4 * q + 2] & 0xFF) << 16) |
           (static_cast<uint32_t>(v[4 * q + 3] & 0xFF) << 24);
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// One run of 16 weights of row n (w is (N, K) row-major, int8 grid or
// float32 quantized here), k from k; zeros beyond K or N.  Returns the
// run's sum (the colsum share).
template <typename WT>
__device__ __forceinline__ int load_w_run(const WT* __restrict__ w, int N,
                                          int K, int n, int k, float dw,
                                          const Params& p, int (&v)[RUN]);

template <>
__device__ __forceinline__ int load_w_run<int8_t>(
    const int8_t* __restrict__ w, int N, int K, int n, int k, float,
    const Params&, int (&v)[RUN]) {
  int s = 0;
  const int8_t* row = w + static_cast<long long>(n) * K;
  if (n < N && k + RUN <= K && (K % RUN) == 0) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + k);
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < RUN; ++e) {
      v[e] = static_cast<int8_t>((u[e >> 2] >> (8 * (e & 3))) & 0xFF);
      s += v[e];
    }
    return s;
  }
#pragma unroll
  for (int e = 0; e < RUN; ++e) {
    v[e] = (n < N && k + e < K) ? static_cast<int>(row[k + e]) : 0;
    s += v[e];
  }
  return s;
}

template <>
__device__ __forceinline__ int load_w_run<float>(
    const float* __restrict__ w, int N, int K, int n, int k, float dw,
    const Params& p, int (&v)[RUN]) {
  int s = 0;
  const float* row = w + static_cast<long long>(n) * K;
  if (n < N && k + RUN <= K && (K % 4) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(row + k + 4 * q);
      v[4 * q] = quant_w(f.x, dw, p);
      v[4 * q + 1] = quant_w(f.y, dw, p);
      v[4 * q + 2] = quant_w(f.z, dw, p);
      v[4 * q + 3] = quant_w(f.w, dw, p);
    }
  } else {
#pragma unroll
    for (int e = 0; e < RUN; ++e)
      v[e] = (n < N && k + e < K) ? quant_w(row[k + e], dw, p) : 0;
  }
#pragma unroll
  for (int e = 0; e < RUN; ++e) s += v[e];
  return s;
}

// 16 consecutive float32 activations from x (or zero-point padding when
// !inside, zeros when !used), quantized; returns their sum.
__device__ __forceinline__ int quant_x_run(const float* __restrict__ src,
                                           bool used, bool inside, bool vec,
                                           int avail, const Params& p,
                                           int (&v)[RUN]) {
  int s = 0;
  if (used && inside && vec && avail >= RUN) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(src + 4 * q);
      v[4 * q] = quant_x(f.x, p);
      v[4 * q + 1] = quant_x(f.y, p);
      v[4 * q + 2] = quant_x(f.z, p);
      v[4 * q + 3] = quant_x(f.w, p);
    }
  } else {
    const int pad = p.zp - 128;
#pragma unroll
    for (int e = 0; e < RUN; ++e)
      v[e] = !used || e >= avail ? 0 : (inside ? quant_x(src[e], p) : pad);
  }
#pragma unroll
  for (int e = 0; e < RUN; ++e) s += v[e];
  return s;
}

using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                       int>;

__device__ __forceinline__ void zero_acc(AccFrag (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0);
}

__device__ __forceinline__ void mma_chunk(const Smem& s, AccFrag (&acc)[2][2],
                                          int warp) {
  using namespace nvcuda;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int pl = 0; pl < PLANES; ++pl) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
        a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major>
        b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(
          a[i], reinterpret_cast<const signed char*>(&s.a[pl][wm + 16 * i][0]),
          RUN);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(
          b[j], reinterpret_cast<const signed char*>(&s.b[pl][wn + 16 * j][0]),
          RUN);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

// Accumulators and the two sums into shared memory; thread t owns row (and
// column) t / 2 of the sums with its neighbour t ^ 1.
__device__ __forceinline__ void finish_tile(Smem& s, AccFrag (&acc)[2][2],
                                            int warp, int tid, int rs,
                                            int cs) {
  using namespace nvcuda;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s.c + (wm + 16 * i) * LDC + wn + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  rs += __shfl_xor_sync(0xffffffffu, rs, 1);
  cs += __shfl_xor_sync(0xffffffffu, cs, 1);
  if ((tid & 1) == 0) {
    s.rowsum[tid >> 1] = rs;
    s.colsum[tid >> 1] = cs;
  }
}

// The epilogue over the tile: y (M, N) float32, row-major.
__device__ __forceinline__ void store_tile(
    const Smem& s, float* __restrict__ out, long long m0, int n0, long long M,
    int N, int K, const Params& p, const float* __restrict__ w_delta,
    const float* __restrict__ scale, const float* __restrict__ shift,
    int activation, int tid) {
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN, n = n0 + c;
    const long long m = m0 + r;
    if (m >= M || n >= N) continue;
    out[m * N + n] = epilogue(s.c[r * LDC + c], s.rowsum[r], s.colsum[c], K,
                              p, fmaxf(w_delta[n], 1e-8f), scale[n], shift[n],
                              activation);
  }
}

}  // namespace i8

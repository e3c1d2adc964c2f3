// Fused quant-matmul for Hopper: y = epilogue(q(x) @ q(w)^T).
//
// Replaces _qmatmul_kernel of fp8_quantization_tpu/ops/pallas/qmatmul.py
// (line 145, pallas_call at line 389).  x is (M, K) float32 or bf16, w is
// (N, K) row-major (torch's Linear layout): float32 to be quantized per
// output channel while it is staged (FP8, or int_sym on the calibrated
// signed or unsigned grid), or bf16 already on the normalized grid
// (baked).  With quantize_input, x is quantized while it is staged (FP8 or
// int_asym) and no output quant follows.  Operands enter the tensor cores
// as bf16 on the normalized grid, exact for <= 8-bit grids, and accumulate
// in fp32.  The epilogue folds the in-kernel weight factor and the input's
// factor back in, as the Pallas body does, then y*scale + shift,
// relu/relu6 and the optional output quant (FP8 or int_asym), stored as
// float32 or (emit_norm) as the normalized bf16 value.  Ragged M, N and K
// are masked in the kernel; the host makes no padded copies.
//
// Bound on the card: the ResNet-18 shapes are small (the downsample 1x1s at
// K = 64..256, the fc at M = batch), so bytes and launch latency bound it,
// not the tensor cores.  Design: one pass over x and w per 64x64 output
// tile, quantization done while staging, the epilogue in registers and one
// store of the (bf16) result.  Simple first: a single shared-memory stage
// with wmma; cp.async/TMA pipelining and wgmma are later work.
#include "fq_epilogue.cuh"

namespace {

template <typename XT, typename WT>
__global__ void __launch_bounds__(fq::THREADS)
qmatmul_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
               const float* __restrict__ wconsts,
               const float* __restrict__ aconsts,
               const float* __restrict__ scale, const float* __restrict__ shift,
               void* __restrict__ out, int M, int N, int K, int w_method,
               int a_method, bool quantize_input, int activation,
               bool emit_norm) {
  using namespace fq;
  __shared__ GemmSmem s;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const QuantConsts ac = load_consts(aconsts, 1, 0);
  const int x_method = quantize_input ? a_method : kQuantNone;
  const int out_method = quantize_input ? kQuantNone : a_method;

  AccFrag acc[2][2];
  zero_acc(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // A chunk: consecutive threads read consecutive k of one row.
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK, m = m0 + r, k = k0 + kk;
      float v = 0.0f;
      if (m < M && k < K)
        v = quantize(to_float(x[static_cast<long long>(m) * K + k]), x_method,
                     ac, true);
      s.a[r * LDA + kk] = __float2bfloat16_rn(v);
    }
    // B chunk: w row n, columns k0..k0+BK, stored transposed (k-major).
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int c = i / BK, kk = i % BK, n = n0 + c, k = k0 + kk;
      float v = 0.0f;
      if (n < N && k < K) {
        v = to_float(w[static_cast<long long>(n) * K + k]);
        if (w_method != kQuantNone)
          v = quantize(v, w_method, load_consts(wconsts, N, n), true);
      }
      s.b[kk * LDB + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    mma_chunk(s, acc, warp);
    __syncthreads();
  }
  store_acc(s, acc, warp);
  __syncthreads();

  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float y = s.c[r * LDC + c];
    if (w_method != kQuantNone) y = __fmul_rn(y, wconsts[5 * N + n]);
    if (x_method != kQuantNone) y = __fmul_rn(y, ac.factor());
    y = epilogue(y, scale[n], shift[n], false, 0.0f, activation, out_method,
                 ac, emit_norm);
    store_out(out, static_cast<long long>(m) * N + n, y, emit_norm);
  }
}

template <typename XT, typename WT>
void launch(const void* x, const void* w, const float* wconsts,
            const float* aconsts, const float* scale, const float* shift,
            void* out, int M, int N, int K, int w_method, int a_method,
            int quantize_input, int activation, int emit_norm,
            cudaStream_t stream) {
  const dim3 grid((M + fq::BM - 1) / fq::BM, (N + fq::BN - 1) / fq::BN);
  qmatmul_kernel<XT, WT><<<grid, fq::THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w), wconsts, aconsts,
      scale, shift, out, M, N, K, w_method, a_method, quantize_input != 0,
      activation, emit_norm != 0);
}

}  // namespace

// w_method: kQuantNone (baked bf16 w), kQuantFp8 or kQuantIntSym (float32
// w, quantized per channel by the (6, N) wconsts); a_method: kQuantNone,
// kQuantFp8 or kQuantIntAsym, the input's quantizer under quantize_input,
// else the output's, by the (6, 1) aconsts.
extern "C" int qmatmul_launch(const void* x, int x_bf16, const void* w,
                              int w_bf16, const float* wconsts,
                              const float* aconsts, const float* scale,
                              const float* shift, void* out, int M, int N,
                              int K, int w_method, int a_method,
                              int quantize_input, int activation,
                              int emit_norm, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, wconsts, aconsts, scale, shift,
                                         out, M, N, K, w_method, a_method,
                                         quantize_input, activation, emit_norm,
                                         st);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, w, wconsts, aconsts, scale, shift, out, M,
                                 N, K, w_method, a_method, quantize_input,
                                 activation, emit_norm, st);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(x, w, wconsts, aconsts, scale, shift, out, M,
                                 N, K, w_method, a_method, quantize_input,
                                 activation, emit_norm, st);
  else
    launch<float, float>(x, w, wconsts, aconsts, scale, shift, out, M, N, K,
                         w_method, a_method, quantize_input, activation,
                         emit_norm, st);
  return static_cast<int>(cudaGetLastError());
}

// Int8 quant-matmul for Hopper: y = epilogue(xs @ wsg^T + corrections).
//
// Replaces _qmatmul_int8_kernel of fp8_quantization_tpu/ops/pallas/
// qmatmul.py (line 212, pallas_call at line 389).  x is (M, K) float32,
// quantized to s8 on the asymmetric grid while its tile is staged; w is
// (N, K) row-major, either the baked int8 grid (w_prequant) or float32
// quantized per output channel while staged.  The s8 x s8 products run on
// the integer tensor cores (wmma 16x16x16, int32 sums) and rowsum(xs) and
// colsum(wsg) are summed beside them; the corrections and the float
// epilogue are in int8_epilogue.cuh.  Ragged M, N and K are masked in the
// kernel and the K term uses the true K: the host makes no padded copies
// (the Pallas wrapper pads K and relies on the padding cancelling).
//
// Bound on the card: at ResNet-18's shapes (the 1x1/2 downsamples at
// K = 64..256 and the fc at M = batch) it reads float32 activations and
// writes float32 outputs for few operations per byte, so bytes bound it, by
// far.  Design: one pass over x and w per 64x64 output tile, the quant done
// while staging, 16-byte loads where K allows, one store of the result.  A
// single shared-memory stage with wmma; cp.async/TMA pipelining and
// reading the bf16 factored input directly are later work.
#include "int8_epilogue.cuh"

namespace {

template <typename WT>
__global__ void __launch_bounds__(i8::THREADS)
qmatmul_int8_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                    const float* __restrict__ w_delta,
                    const float* __restrict__ w_scalars,
                    const float* __restrict__ a_scalars,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, float* __restrict__ out,
                    int M, int N, int K, int a_bits, int w_bits,
                    int activation) {
  using namespace i8;
  __shared__ Smem s;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const Params p = load_params(a_scalars, w_scalars, a_bits, w_bits);

  const int r = tid >> 1, half = (tid & 1) * 2 * RUN;
  const int m = m0 + r, n = n0 + r;
  const bool row_ok = m < M, vec = (K % 4) == 0;
  const float dw = n < N ? fmaxf(w_delta[n], 1e-8f) : 1.0f;
  const float* xrow = x + static_cast<long long>(row_ok ? m : 0) * K;

  AccFrag acc[2][2];
  zero_acc(acc);
  int rs = 0, cs = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + half + RUN * u, pl = (half + RUN * u) / RUN;
      int v[RUN];
      rs += quant_x_run(xrow + k, row_ok, true, vec, K - k, p, v);
      put_run(&s.a[pl][r][0], v);
      cs += load_w_run<WT>(w, N, K, n, k, dw, p, v);
      put_run(&s.b[pl][r][0], v);
    }
    __syncthreads();
    mma_chunk(s, acc, warp);
    __syncthreads();
  }
  finish_tile(s, acc, warp, tid, rs, cs);
  __syncthreads();
  store_tile(s, out, m0, n0, M, N, K, p, w_delta, scale, shift, activation,
             tid);
}

}  // namespace

extern "C" int qmatmul_int8_launch(const float* x, const void* w, int w_int8,
                                   const float* w_delta,
                                   const float* w_scalars,
                                   const float* a_scalars, const float* scale,
                                   const float* shift, float* out, int M,
                                   int N, int K, int a_bits, int w_bits,
                                   int activation, void* stream) {
  const dim3 grid((M + i8::BM - 1) / i8::BM, (N + i8::BN - 1) / i8::BN);
  auto st = static_cast<cudaStream_t>(stream);
  if (w_int8)
    qmatmul_int8_kernel<int8_t><<<grid, i8::THREADS, 0, st>>>(
        x, static_cast<const int8_t*>(w), w_delta, w_scalars, a_scalars, scale,
        shift, out, M, N, K, a_bits, w_bits, activation);
  else
    qmatmul_int8_kernel<float><<<grid, i8::THREADS, 0, st>>>(
        x, static_cast<const float*>(w), w_delta, w_scalars, a_scalars, scale,
        shift, out, M, N, K, a_bits, w_bits, activation);
  return static_cast<int>(cudaGetLastError());
}

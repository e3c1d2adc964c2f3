// Int8 3x3 SAME conv for Hopper: implicit s8 GEMM + exact corrections.
//
// Replaces _qconv3x3_int8_kernel of fp8_quantization_tpu/ops/pallas/
// qconv.py (line 278, pallas_call at line 442).  The Pallas kernel builds an
// s8 im2col of whole images in VMEM; here it is an implicit GEMM over NHWC
// with M = N*Ho*Wo output pixels, K = 9*Cin (column k is tap (dy, dx) =
// divmod(k / Cin, 3) and channel k % Cin) and N = Cout, tiled 64 x 64.
// Each A run of 16 channels is gathered from the float32 input and
// quantized to s8 on the asymmetric grid while it is staged; a tap outside
// the image reads zp - 128, the real zero, in the product and in the rowsum,
// so the rowsum is the 3x3 window sum padding included and the identity
// holds per output.  Stride 2 is index arithmetic (the Pallas even/odd
// phase split is not needed).  w is the (Cout, 9*Cin) matrix, row-major:
// the baked int8 grid or float32 quantized per output channel while staged.
// Products on the integer tensor cores, corrections and epilogue in
// int8_epilogue.cuh.
//
// Bound on the card: the kernel reads float32 activations and writes
// float32 outputs, and at 1,979 TOP/s the s8 products are cheap next to
// those bytes: every ResNet-18 shape but the last (7x7x512, bound by
// operations) is bound by bytes, and so is their sum over a forward.
// Design: the input is read in 16-byte loads (Cin % 16 == 0), quantized
// once per tap it feeds, and the output written once.  A single
// shared-memory stage with wmma; quantizing each input once, cp.async/TMA
// pipelining and reading the bf16 factored input are later work.
#include "int8_epilogue.cuh"

namespace {

template <typename WT>
__global__ void __launch_bounds__(i8::THREADS)
qconv3x3_int8_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                     const float* __restrict__ w_delta,
                     const float* __restrict__ w_scalars,
                     const float* __restrict__ a_scalars,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ out,
                     int Nimg, int H, int W, int Cin, int Cout, int stride,
                     int Ho, int Wo, int a_bits, int w_bits, int activation) {
  using namespace i8;
  __shared__ Smem s;
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long M = static_cast<long long>(Nimg) * Ho * Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;
  const Params p = load_params(a_scalars, w_scalars, a_bits, w_bits);

  // This thread stages A row r (one output pixel) and B row n, k from half.
  const int r = tid >> 1, half = (tid & 1) * 2 * RUN;
  const long long m = m0 + r;
  const bool row_ok = m < M;
  const long long mm = row_ok ? m : 0;
  const int ow = static_cast<int>(mm % Wo);
  const int oh = static_cast<int>((mm / Wo) % Ho);
  const long long img = (mm / (static_cast<long long>(Wo) * Ho)) * H * W;
  const int ih0 = oh * stride - 1, iw0 = ow * stride - 1;
  const int n = n0 + r;
  const float dw = n < Cout ? fmaxf(w_delta[n], 1e-8f) : 1.0f;

  AccFrag acc[2][2];
  zero_acc(acc);
  int rs = 0, cs = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + half + RUN * u, pl = (half + RUN * u) / RUN;
      const int tap = k / Cin, ci = k - tap * Cin;
      const int ih = ih0 + tap / 3, iw = iw0 + tap % 3;
      const bool inside = ih >= 0 && ih < H && iw >= 0 && iw < W;
      const float* src =
          x + ((img + static_cast<long long>(inside ? ih : 0) * W +
                (inside ? iw : 0)) * Cin + ci);
      int v[RUN];
      rs += quant_x_run(src, row_ok, inside, true, K - k, p, v);
      put_run(&s.a[pl][r][0], v);
      cs += load_w_run<WT>(w, Cout, K, n, k, dw, p, v);
      put_run(&s.b[pl][r][0], v);
    }
    __syncthreads();
    mma_chunk(s, acc, warp);
    __syncthreads();
  }
  finish_tile(s, acc, warp, tid, rs, cs);
  __syncthreads();
  store_tile(s, out, m0, n0, M, Cout, K, p, w_delta, scale, shift, activation,
             tid);
}

}  // namespace

extern "C" int qconv3x3_int8_launch(const float* x, const void* w, int w_int8,
                                    const float* w_delta,
                                    const float* w_scalars,
                                    const float* a_scalars,
                                    const float* scale, const float* shift,
                                    float* out, int N, int H, int W, int Cin,
                                    int Cout, int stride, int a_bits,
                                    int w_bits, int activation,
                                    void* stream) {
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const long long M = static_cast<long long>(N) * Ho * Wo;
  const dim3 grid(static_cast<unsigned>((M + i8::BM - 1) / i8::BM),
                  (Cout + i8::BN - 1) / i8::BN);
  auto st = static_cast<cudaStream_t>(stream);
  if (w_int8)
    qconv3x3_int8_kernel<int8_t><<<grid, i8::THREADS, 0, st>>>(
        x, static_cast<const int8_t*>(w), w_delta, w_scalars, a_scalars, scale,
        shift, out, N, H, W, Cin, Cout, stride, Ho, Wo, a_bits, w_bits,
        activation);
  else
    qconv3x3_int8_kernel<float><<<grid, i8::THREADS, 0, st>>>(
        x, static_cast<const float*>(w), w_delta, w_scalars, a_scalars, scale,
        shift, out, N, H, W, Cin, Cout, stride, Ho, Wo, a_bits, w_bits,
        activation);
  return static_cast<int>(cudaGetLastError());
}

// Fused 3x3 SAME conv for Hopper: implicit GEMM + epilogue + output quant.
//
// Replaces _qconv3x3_kernel and _conv_epilogue of
// fp8_quantization_tpu/ops/pallas/qconv.py (lines 130 and 111, pallas_call
// at line 472).  The Pallas kernel holds whole images in VMEM; an SM's
// shared memory cannot, so this kernel is an implicit GEMM over NHWC with
// M = N*Ho*Wo output pixels, K = 9*Cin and N = Cout, tiled 64 pixels x 64
// channels.  Each K chunk of A is gathered from the input while staging:
// column k is tap (dy, dx) = divmod(k / Cin, 3) and channel k % Cin, SAME
// padding is a bounds mask and stride 2 is index arithmetic (the Pallas
// even/odd phase split was a Mosaic workaround and is gone).  B is the
// baked (9*Cin, Cout) bf16 weight matrix.  The epilogue is y*scale + shift
// [+ residual], relu/relu6 and the output quant (FP8 or int_asym,
// fq_epilogue.cuh), stored as the normalized bf16 value (emit_norm) or
// float32.
//
// Bound on the card: at ResNet-18's shapes the early layers (56x56x64)
// move about as many bytes as they do tensor-core work at 989 TFLOP/s
// (bf16 input and output ~51 MB at batch 64 vs 14.8 GFLOP); the late layers
// (7x7x512, K = 4608) are bound by operations.  Design: bf16 operands on
// the tensor cores, 16-byte vector gathers (Cin % 8 == 0), the output
// written once in bf16 with the quant fused.  A single shared-memory stage
// with wmma; multi-stage cp.async/TMA and wgmma are later work.
#include "fq_epilogue.cuh"

namespace {

template <typename RT>
__global__ void __launch_bounds__(fq::THREADS)
qconv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ aconsts,
                const float* __restrict__ scale,
                const float* __restrict__ shift, const RT* __restrict__ res,
                void* __restrict__ out, int Nimg, int H, int W, int Cin,
                int Cout, int stride, int Ho, int Wo, int a_method,
                int activation, bool emit_norm) {
  using namespace fq;
  __shared__ GemmSmem s;
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long M = static_cast<long long>(Nimg) * Ho * Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;

  // This thread stages A rows r and r + 32, 8 channels from column kv.
  const int kv = (tid & 3) * 8;
  int ih0[2], iw0[2];
  long long img[2];
  bool valid[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const long long m = m0 + (tid >> 2) + 32 * j;
    valid[j] = m < M;
    const long long mm = valid[j] ? m : 0;
    const int ow = static_cast<int>(mm % Wo);
    const int oh = static_cast<int>((mm / Wo) % Ho);
    img[j] = (mm / (static_cast<long long>(Wo) * Ho)) * H * W;
    ih0[j] = oh * stride - 1;
    iw0[j] = ow * stride - 1;
  }
  // ... and B rows kb and kb + 16, 8 channels from column nb.
  const int kb = tid >> 3, nb = (tid & 7) * 8;

  AccFrag acc[2][2];
  zero_acc(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + kv;
    const int tap = k / Cin, ci = k - tap * Cin;
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint4 v = make_uint4(0, 0, 0, 0);
      const int ih = ih0[j] + dy, iw = iw0[j] + dx;
      if (valid[j] && k < K && ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = *reinterpret_cast<const uint4*>(
            x + ((img[j] + static_cast<long long>(ih) * W + iw) * Cin + ci));
      *reinterpret_cast<uint4*>(s.a + ((tid >> 2) + 32 * j) * LDA + kv) = v;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kr = k0 + kb + 16 * j, n = n0 + nb;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (kr < K && n < Cout)
        v = *reinterpret_cast<const uint4*>(
            w + static_cast<long long>(kr) * Cout + n);
      *reinterpret_cast<uint4*>(s.b + (kb + 16 * j) * LDB + nb) = v;
    }
    __syncthreads();
    mma_chunk(s, acc, warp);
    __syncthreads();
  }
  store_acc(s, acc, warp);
  __syncthreads();

  const QuantConsts ac = load_consts(aconsts, 1, 0);
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN, n = n0 + c;
    const long long m = m0 + r;
    if (m >= M || n >= Cout) continue;
    const long long o = m * Cout + n;
    const float rv = res != nullptr ? to_float(res[o]) : 0.0f;
    const float y = epilogue(s.c[r * LDC + c], scale[n], shift[n],
                             res != nullptr, rv, activation, a_method, ac,
                             emit_norm);
    store_out(out, o, y, emit_norm);
  }
}

}  // namespace

extern "C" int qconv3x3_launch(const void* x, const void* w,
                               const float* aconsts, const float* scale,
                               const float* shift, const void* res,
                               int res_bf16, void* out, int N, int H, int W,
                               int Cin, int Cout, int stride, int a_method,
                               int activation, int emit_norm, void* stream) {
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const long long M = static_cast<long long>(N) * Ho * Wo;
  const dim3 grid(static_cast<unsigned>((M + fq::BM - 1) / fq::BM),
                  (Cout + fq::BN - 1) / fq::BN);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  if (res_bf16)
    qconv3x3_kernel<__nv_bfloat16><<<grid, fq::THREADS, 0, st>>>(
        xb, wb, aconsts, scale, shift,
        static_cast<const __nv_bfloat16*>(res), out, N, H, W, Cin, Cout,
        stride, Ho, Wo, a_method, activation, emit_norm != 0);
  else
    qconv3x3_kernel<float><<<grid, fq::THREADS, 0, st>>>(
        xb, wb, aconsts, scale, shift, static_cast<const float*>(res), out, N,
        H, W, Cin, Cout, stride, Ho, Wo, a_method, activation,
        emit_norm != 0);
  return static_cast<int>(cudaGetLastError());
}

// Fused depthwise 3x3 SAME conv for Hopper: 9-tap stencil + epilogue +
// output quant.
//
// Replaces _qdwconv3x3_kernel of fp8_quantization_tpu/ops/pallas/qconv.py
// (line 183, pallas_call at line 251).  The Pallas kernel holds whole images
// in VMEM and builds stride 2 from even/odd phase planes; here each thread
// owns one output pixel and a vector of VEC channels (8 when C % 8 == 0,
// else 1), reads the nine taps straight from device memory with SAME padding
// as a bounds mask (an out-of-image tap reads 0) and stride 2 as index
// arithmetic.  It sums the nine products in float32 in (dy, dx) row-major
// order, as the Pallas body does (qconv.py:203-207); with -fmad=false and
// the _rn intrinsics every step is the plain version's, bit for bit (each
// product of a bf16 input and a bf16-exact weight is exact in float32).
// Then y*scale + shift, relu/relu6 and the output quant, FP8 or int_asym
// (fq_epilogue.cuh), stored as the normalized bf16 value (emit_norm) or
// float32.
//
// Bound on the card: bytes.  Per output element it does 18 operations and
// moves 2 bytes out plus 2*s^2 bytes in (bf16), about 18 operations per 4
// bytes at stride 1, far below the 295 operations per byte at which the
// H100 turns compute-bound.  Design: 16-byte vector loads of 8 channels,
// neighbouring threads on neighbouring channel vectors (coalesced), the
// input read once from device memory (the taps that overlap between
// neighbouring pixels come from L1/L2) and the output written once.
#include "fq_epilogue.cuh"

namespace {

constexpr int kThreads = 256;

// VEC bf16 values from p as floats, or zeros when !in_image.
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, bool in_image,
                                         float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (in_image) raw = *reinterpret_cast<const uint4*>(p);
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      v[i] = in_image ? __bfloat162float(p[i]) : 0.0f;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
qdwconv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ w,
                  const float* __restrict__ aconsts,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, void* __restrict__ out,
                  int Nimg, int H, int W, int C, int stride, int Ho, int Wo,
                  int a_method, int activation, bool emit_norm) {
  const int CV = C / VEC;
  const long long total = static_cast<long long>(Nimg) * Ho * Wo * CV;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int c0 = static_cast<int>(i % CV) * VEC;
  const long long pix = i / CV;
  const int ow = static_cast<int>(pix % Wo);
  const int oh = static_cast<int>((pix / Wo) % Ho);
  const long long img = pix / (static_cast<long long>(Wo) * Ho);

  float acc[VEC];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int ih = oh * stride - 1 + dy;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int iw = ow * stride - 1 + dx;
      const bool in_image = ih >= 0 && ih < H && iw >= 0 && iw < W;
      const long long off =
          in_image ? ((img * H + ih) * W + iw) * static_cast<long long>(C) + c0
                   : 0;
      float xv[VEC];
      load_vec<VEC>(x + off, in_image, xv);
      const float* wt = w + (dy * 3 + dx) * C + c0;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float term = __fmul_rn(xv[v], __ldg(wt + v));
        acc[v] = (dy == 0 && dx == 0) ? term : __fadd_rn(acc[v], term);
      }
    }
  }

  const fq::QuantConsts ac = fq::load_consts(aconsts, 1, 0);
  const long long o = pix * C + c0;
  float y[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    y[v] = fq::epilogue(acc[v], __ldg(scale + c0 + v), __ldg(shift + c0 + v),
                        false, 0.0f, activation, a_method, ac, emit_norm);
  if constexpr (VEC == 8) {
    if (emit_norm) {
      uint4 packed;
      auto* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        h[k] = __floats2bfloat162_rn(y[2 * k], y[2 * k + 1]);
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + o) = packed;
    } else {
      auto* f = reinterpret_cast<float4*>(static_cast<float*>(out) + o);
      f[0] = make_float4(y[0], y[1], y[2], y[3]);
      f[1] = make_float4(y[4], y[5], y[6], y[7]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) fq::store_out(out, o + v, y[v], emit_norm);
  }
}

}  // namespace

extern "C" int qdwconv3x3_launch(const void* x, const float* w,
                                 const float* aconsts, const float* scale,
                                 const float* shift, void* out, int N, int H,
                                 int W, int C, int stride, int a_method,
                                 int activation, int emit_norm, void* stream) {
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const int vec = C % 8 == 0 ? 8 : 1;
  const long long total = static_cast<long long>(N) * Ho * Wo * (C / vec);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  if (vec == 8)
    qdwconv3x3_kernel<8><<<blocks, kThreads, 0, st>>>(
        xb, w, aconsts, scale, shift, out, N, H, W, C, stride, Ho, Wo,
        a_method, activation, emit_norm != 0);
  else
    qdwconv3x3_kernel<1><<<blocks, kThreads, 0, st>>>(
        xb, w, aconsts, scale, shift, out, N, H, W, C, stride, Ho, Wo,
        a_method, activation, emit_norm != 0);
  return static_cast<int>(cudaGetLastError());
}

// Fused MobileNetV2 inverted-residual block for Hopper:
//   expand 1x1 + fold + relu6 + quant -> depthwise 3x3 + fold + relu6 +
//   quant -> project 1x1 + fold + quant [+ residual + block quant].
//
// Replaces _ir_block_kernel of fp8_quantization_tpu/ops/pallas/qblock.py
// (line 82, pallas_call at line 267).  The Pallas kernel keeps a group of
// whole expanded images in VMEM (up to 112x112x96 floats an image); an SM
// has 227 KB of shared memory.  So each block here owns one image's T x T
// tile of output pixels (T = 8, or 4 when the output is smaller than 8)
// and walks the hidden channels in chunks of HC (a multiple of 16):
//
//   1. once: stage the tile's input pixels and their one-pixel halo
//      ((T-1)*s + 3 on a side), zero outside the image, as bf16;
//   2. per chunk: expand the staged pixels with bf16 wmma (fp32 sums), then
//      y*scale1 + shift1, relu6, the expand quant (normalized) and a bf16
//      store, with every pixel outside the image set to 0 after the
//      expansion (the Pallas body pads the expanded tensor, qblock.py:132);
//      in a t=1 block the chunk is the staged input itself;
//   3. the depthwise stencil on the chunk: nine products summed in float32
//      in (dy, dx) row-major order, y*scale_d + shift_d, relu6, the dw
//      quant (normalized), bf16;
//   4. the project product of the chunk added into an fp32 accumulator of
//      (T*T, Cout) in shared memory with bf16 wmma;
//   5. after the last chunk: y*scale2 + shift2, then the project quant, or
//      (residual) the full-scale project quant, + x*x_factor and the block
//      quant; stored as normalized bf16 or float32.
//
// Each stage quantizes by its own method (FP8, int_asym or none), two bits
// of ``methods`` per stage (stage r at bits 2r, 2r+1; fq_epilogue.cuh's
// QuantMethod codes); a stage without a quantizer is a plain bf16 cast (the
// dw_bf16_acts preset).  Quantizers come as a (6, 4) constant array, one
// column per stage (fq_epilogue.cuh).  Built with -fmad=false, so every epilogue step
// rounds as the plain version's does; the sums of the two products run in
// another order (wmma, and the project over chunks).
//
// Bound on the card: at MobileNetV2's shapes the block moves its bf16 input
// and output once (the expanded tensor stays on the SM) and does 2*Cin*hid
// + 18*hid + 2*hid*Cout operations per output pixel (times s^2 for the
// expand at stride 2): about 50-330 operations per byte, so the early
// blocks are bound by bytes and the late ones near the H100's 295
// operations per byte.  This first version recomputes the expansion on the
// halo (up to 2.25x at 4x4 tiles), stages through shared memory without
// pipelining and runs one or two blocks an SM; cp.async/TMA staging and
// wgmma are later work.
#include "fq_epilogue.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kPadB = 8;   // row padding of bf16 tiles, in elements
constexpr int kPadF = 4;   // row padding of float tiles, in elements
constexpr int kScrLd = 16 + kPadF;
constexpr size_t kMaxSmem = 232448;       // 227 KB, the H100's per-block limit
constexpr size_t kTwoBlocksSmem = 113 * 1024;

struct Geometry {
  int T, TP, TI, P, Pp, Kp, HC, Np;
  int ldx, ldw1, ldh, ldn2, ldw2, ldacc;
  size_t off_w1, off_h, off_n2, off_w2, off_acc, off_scr, bytes;
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
inline size_t align128(size_t v) { return (v + 127) / 128 * 128; }

Geometry make_geometry(int Ho, int stride, int cin, int cout, int expand,
                       int HC) {
  Geometry g{};
  g.T = Ho >= 8 ? 8 : 4;
  g.TP = g.T * g.T;
  g.TI = (g.T - 1) * stride + 3;
  g.P = g.TI * g.TI;
  g.Pp = round16(g.P);
  g.Kp = round16(cin);
  g.HC = HC;
  g.Np = round16(cout);
  g.ldx = g.Kp + kPadB;
  g.ldw1 = g.HC + kPadB;
  g.ldh = g.HC + kPadB;
  g.ldn2 = g.HC + kPadB;
  g.ldw2 = g.Np + kPadB;
  g.ldacc = g.Np + kPadF;
  size_t off = align128(static_cast<size_t>(g.Pp) * g.ldx * 2);
  g.off_w1 = off;
  off += expand ? align128(static_cast<size_t>(g.Kp) * g.ldw1 * 2) : 0;
  g.off_h = off;
  off += align128(static_cast<size_t>(g.Pp) * g.ldh * 2);
  g.off_n2 = off;
  off += align128(static_cast<size_t>(g.TP) * g.ldn2 * 2);
  g.off_w2 = off;
  off += align128(static_cast<size_t>(g.HC) * g.ldw2 * 2);
  g.off_acc = off;
  off += align128(static_cast<size_t>(g.TP) * g.ldacc * 4);
  g.off_scr = off;
  off += static_cast<size_t>(kWarps) * 16 * kScrLd * 4;
  g.bytes = off;
  return g;
}

// One stage's epilogue: y*scale + shift, activation, and the stage's quant
// (method code ``quant``, kQuantNone for none).
__device__ __forceinline__ float stage(float y, float scale, float shift,
                                       int activation, int quant,
                                       const fq::QuantConsts& c,
                                       bool normalized) {
  return fq::epilogue(y, scale, shift, false, 0.0f, activation, quant, c,
                      normalized);
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(kThreads)
qblock_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w1,
              const float* __restrict__ wd,
              const __nv_bfloat16* __restrict__ w2,
              const float* __restrict__ aconsts,
              const float* __restrict__ s1, const float* __restrict__ b1,
              const float* __restrict__ sd, const float* __restrict__ bd,
              const float* __restrict__ s2, const float* __restrict__ b2,
              const float* __restrict__ xfactor, void* __restrict__ out,
              Geometry g, int H, int W, int Cin, int hid, int Cout,
              int stride, int Ho, int Wo, bool expand, bool use_res,
              int methods, bool emit_norm, bool out_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* w1s = reinterpret_cast<__nv_bfloat16*>(smem + g.off_w1);
  auto* hs = reinterpret_cast<__nv_bfloat16*>(smem + g.off_h);
  auto* n2s = reinterpret_cast<__nv_bfloat16*>(smem + g.off_n2);
  auto* w2s = reinterpret_cast<__nv_bfloat16*>(smem + g.off_w2);
  auto* accs = reinterpret_cast<float*>(smem + g.off_acc);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* scr = reinterpret_cast<float*>(smem + g.off_scr) + warp * 16 * kScrLd;

  const int tiles_w = (Wo + g.T - 1) / g.T;
  const int oh0 = (blockIdx.x / tiles_w) * g.T;
  const int ow0 = (blockIdx.x % tiles_w) * g.T;
  const long long img = blockIdx.y;
  const int ih0 = oh0 * stride - 1, iw0 = ow0 * stride - 1;
  const fq::QuantConsts c_exp = fq::load_consts(aconsts, 4, 0);
  const fq::QuantConsts c_dw = fq::load_consts(aconsts, 4, 1);
  const fq::QuantConsts c_proj = fq::load_consts(aconsts, 4, 2);
  const fq::QuantConsts c_blk = fq::load_consts(aconsts, 4, 3);
  const int q_exp = methods & 3, q_dw = (methods >> 2) & 3,
            q_proj = (methods >> 4) & 3, q_blk = (methods >> 6) & 3;

  // 1. the input tile with its halo, zero outside the image and in padding
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int e = tid; e < g.Pp * g.Kp; e += kThreads) {
    const int p = e / g.Kp, k = e - p * g.Kp;
    const int ih = ih0 + p / g.TI, iw = iw0 + p % g.TI;
    __nv_bfloat16 v = zero;
    if (p < g.P && k < Cin && ih >= 0 && ih < H && iw >= 0 && iw < W)
      v = x[((img * H + ih) * W + iw) * Cin + k];
    xs[p * g.ldx + k] = v;
  }
  for (int e = tid; e < g.TP * g.ldacc; e += kThreads) accs[e] = 0.0f;
  __syncthreads();

  for (int j0 = 0; j0 < hid; j0 += g.HC) {
    const int hc = min(g.HC, hid - j0);   // valid channels of this chunk
    if (expand)
      for (int e = tid; e < g.Kp * g.HC; e += kThreads) {
        const int k = e / g.HC, j = e - k * g.HC;
        w1s[k * g.ldw1 + j] =
            (k < Cin && j < hc) ? w1[static_cast<long long>(k) * hid + j0 + j]
                                : zero;
      }
    for (int e = tid; e < g.HC * g.Np; e += kThreads) {
      const int j = e / g.Np, c = e - j * g.Np;
      w2s[j * g.ldw2 + c] =
          (j < hc && c < Cout) ? w2[static_cast<long long>(j0 + j) * Cout + c]
                               : zero;
    }
    __syncthreads();

    // 2. the expanded chunk of the tile's input pixels, 0 outside the image
    if (expand) {
      const int mt = g.Pp / 16, nt = g.HC / 16;
      for (int t = warp; t < mt * nt; t += kWarps) {
        const int mi = t / nt, ni = t - mi * nt;
        FragC acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int k = 0; k < g.Kp; k += 16) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, xs + mi * 16 * g.ldx + k, g.ldx);
          wmma::load_matrix_sync(b, w1s + k * g.ldw1 + ni * 16, g.ldw1);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(scr, acc, kScrLd, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int p = mi * 16 + e / 16, j = ni * 16 + e % 16;
          const int ih = ih0 + p / g.TI, iw = iw0 + p % g.TI;
          float hv = 0.0f;
          if (p < g.P && j < hc && ih >= 0 && ih < H && iw >= 0 && iw < W)
            hv = stage(scr[(e / 16) * kScrLd + e % 16], s1[j0 + j], b1[j0 + j],
                       fq::kActRelu6, q_exp, c_exp, true);
          hs[p * g.ldh + j] = __float2bfloat16_rn(hv);
        }
        __syncwarp();
      }
    } else {
      for (int e = tid; e < g.Pp * g.HC; e += kThreads) {
        const int p = e / g.HC, j = e - p * g.HC;
        hs[p * g.ldh + j] = j < hc ? xs[p * g.ldx + j0 + j] : zero;
      }
    }
    __syncthreads();

    // 3. the depthwise stencil on the chunk
    for (int e = tid; e < g.TP * g.HC; e += kThreads) {
      const int o = e / g.HC, j = e - o * g.HC;
      const int oi = o / g.T, oj = o - oi * g.T;
      float nv = 0.0f;
      if (j < hc) {
        const float* wt = wd + j0 + j;
        float acc = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int p = (oi * stride + dy) * g.TI + oj * stride + dx;
            const float term = __fmul_rn(__bfloat162float(hs[p * g.ldh + j]),
                                         __ldg(wt + (dy * 3 + dx) * hid));
            acc = (dy == 0 && dx == 0) ? term : __fadd_rn(acc, term);
          }
        nv = stage(acc, sd[j0 + j], bd[j0 + j], fq::kActRelu6, q_dw, c_dw,
                   true);
      }
      n2s[o * g.ldn2 + j] = __float2bfloat16_rn(nv);
    }
    __syncthreads();

    // 4. the project product of the chunk into the accumulator
    {
      const int mt = g.TP / 16, nt = g.Np / 16;
      for (int t = warp; t < mt * nt; t += kWarps) {
        const int mi = t / nt, ni = t - mi * nt;
        float* cp = accs + mi * 16 * g.ldacc + ni * 16;
        FragC acc;
        wmma::load_matrix_sync(acc, cp, g.ldacc, wmma::mem_row_major);
        for (int k = 0; k < g.HC; k += 16) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, n2s + mi * 16 * g.ldn2 + k, g.ldn2);
          wmma::load_matrix_sync(b, w2s + k * g.ldw2 + ni * 16, g.ldw2);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(cp, acc, g.ldacc, wmma::mem_row_major);
      }
    }
    __syncthreads();
  }

  // 5. the project epilogue [+ residual + block quant], one store
  const float xf = *xfactor;
  for (int e = tid; e < g.TP * Cout; e += kThreads) {
    const int o = e / Cout, c = e - o * Cout;
    const int oi = o / g.T, oj = o - oi * g.T;
    const int oh = oh0 + oi, ow = ow0 + oj;
    if (oh >= Ho || ow >= Wo) continue;
    float y;
    if (use_res) {
      y = stage(accs[o * g.ldacc + c], s2[c], b2[c], fq::kActNone, q_proj,
                c_proj, false);
      const float xr = __bfloat162float(
          xs[((oi + 1) * g.TI + oj + 1) * g.ldx + c]);
      y = __fadd_rn(y, __fmul_rn(xr, xf));
      y = fq::quantize(y, q_blk, c_blk, emit_norm);
    } else {
      y = stage(accs[o * g.ldacc + c], s2[c], b2[c], fq::kActNone, q_proj,
                c_proj, emit_norm);
    }
    fq::store_out(out, ((img * Ho + oh) * Wo + ow) * Cout + c, y, out_bf16);
  }
}

// The largest chunk of hidden channels (a multiple of 16) that divides hid
// and keeps two blocks an SM; else the largest that fits at all (a chunk
// that does not divide hid leaves a ragged last chunk, masked).
bool choose_geometry(int Ho, int stride, int cin, int hid, int cout,
                     int expand, Geometry* out) {
  const int cands[] = {64, 48, 32, 16};
  for (int pass = 0; pass < 3; ++pass)
    for (int hc : cands) {
      if (pass < 2 && hid % hc != 0) continue;
      const Geometry g = make_geometry(Ho, stride, cin, cout, expand, hc);
      if (g.bytes <= (pass == 0 ? kTwoBlocksSmem : kMaxSmem)) {
        *out = g;
        return true;
      }
    }
  return false;
}

}  // namespace

extern "C" int qblock_launch(const void* x, const void* w1, const float* wd,
                             const void* w2, const float* aconsts,
                             const float* s1, const float* b1,
                             const float* sd, const float* bd,
                             const float* s2, const float* b2,
                             const float* xfactor, void* out, int N, int H,
                             int W, int Cin, int hid, int Cout, int stride,
                             int expand, int use_res, int methods,
                             int emit_norm, int out_bf16, void* stream) {
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  Geometry g;
  if (!choose_geometry(Ho, stride, Cin, hid, Cout, expand, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      qblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((Ho + g.T - 1) / g.T) * ((Wo + g.T - 1) / g.T);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(N));
  qblock_kernel<<<grid, kThreads, g.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), wd,
      static_cast<const __nv_bfloat16*>(w2), aconsts, s1, b1, sd, bd, s2, b2,
      xfactor, out, g, H, W, Cin, hid, Cout, stride, Ho, Wo, expand != 0,
      use_res != 0, methods, emit_norm != 0, out_bf16 != 0);
  return static_cast<int>(cudaGetLastError());
}

// Fused MobileNetV2 inverted-residual block for Hopper:
//   expand 1x1 + fold + relu6 + quant -> depthwise 3x3 + fold + relu6 +
//   quant -> project 1x1 + fold + quant [+ residual + block quant].
//
// Replaces _ir_block_kernel of fp8_quantization_tpu/ops/pallas/qblock.py
// (line 82, pallas_call at line 267).  The Pallas kernel keeps a group of
// whole expanded images in VMEM (up to 112x112x96 floats an image); an SM
// has 227 KB of shared memory.  So a cluster of CS blocks (block_tile
// picks 1 or 2; the kernel takes up to 4) owns one image's th x tw tile of
// output pixels, each block a slice of the hidden channels, walked in
// chunks of hc (a multiple of 16); the tile, CS, hc and the block's warps
// come from ops/kernels/qblock.block_tile:
//
//   1. once: the tile's input pixels and their one-pixel halo (ph x pw),
//      zero outside the image, by 16-byte cp.async; and per chunk, into a
//      two-stage ring by cp.async, the chunk's w1 columns, w2 rows,
//      depthwise taps and folded scale/shift, chunk j + 1 in flight while
//      chunk j computes;
//   2. per chunk: the expand product on mma.sync (bf16, fp32 sums) and, on
//      its fragments in registers, y*scale1 + shift1, relu6, the expand
//      quant (normalized), 0 for every pixel outside the image (the Pallas
//      body pads the expanded tensor, qblock.py:132), one bf16 store; in a
//      t=1 block the chunk is the staged input itself;
//   3. the depthwise stencil on the chunk, two channels a thread: nine
//      products summed in float32 in (dy, dx) row-major order, y*scale_d +
//      shift_d, relu6, the dw quant (normalized), bf16;
//   4. the project product of the chunk on mma.sync into fp32 accumulators
//      that stay in registers across all chunks, each warp owning a fixed
//      run of (16-row x 8-channel) tiles of the tile's (pixels x Cout);
//   5. after the last chunk the partial sums go to shared memory; with
//      CS > 1 each block of the cluster reads its share of the pixels from
//      every block's partials through distributed shared memory, adds them
//      in rank order, and applies y*scale2 + shift2, then the project
//      quant, or (residual) the full-scale project quant, + x*x_factor and
//      the block quant; stored as normalized bf16 or float32.
//
// Each stage quantizes by its own method (FP8, int_asym or none), two bits
// of ``methods`` per stage (stage r at bits 2r, 2r+1; fq_epilogue.cuh's
// QuantMethod codes); a stage without a quantizer is a plain bf16 cast (the
// dw_bf16_acts preset).  Quantizers come as a (6, 4) constant array, one
// column per stage (fq_epilogue.cuh).  Built with -fmad=false, so every
// epilogue step rounds as the plain version's does; the sums of the two
// products run in another order (mma, the project over chunks and ranks).
// Cin, hid and Cout must be multiples of 8 (16-byte rows; the wrapper
// raises otherwise), as every MobileNetV2 width is.
//
// Bound on the card: at MobileNetV2's shapes the block moves its bf16 input
// and output once (the expanded tensor stays on the SM) and does 2*Cin*hid
// + 18*hid + 2*hid*Cout operations per output pixel (times s^2 for the
// expand at stride 2): about 50-330 operations per byte, so the early
// blocks are bound by bytes and the late ones near the H100's 295
// operations per byte.  In practice the per-value epilogues bound it: the
// expand and dw quantizers run on every expanded and filtered value (about
// 25 instructions each), and a chunk's phases are serial in a block.  What
// the design does about it:
//   * the tile is sized to the map (16 x 16 and 14 x 14 pixels on the
//     large maps, two or three blocks of 8 warps an SM, or one of 16 where
//     shared memory holds one; whole images from 14x14 down, one block of
//     16 warps an SM), which cuts the expansion recomputed on the halo (at
//     most 1.65x at 7x7, 1.31x above, was up to 2.94x), and from 14x14
//     down the hid split over a 2-block cluster stages each weight byte
//     once per image, not once per 16-64 pixels, in one wave of 128 blocks
//     at batch 64 (0.26 GB of weights per MobileNetV2 forward, was 1.0);
//   * the quantizers divide by nothing: fq::quantize_inv scales by 2^-p
//     exactly and divides by the tensor's factor through its reciprocal
//     and one Newton step (correctly rounded, so every value is the plain
//     version's), and reads the FP8 bin with integer operations;
//   * the per-value code of the expand and dw epilogues is compiled once
//     per quantizer method and branch-free (out-of-image pixels and the
//     chunk's padding are selected to 0), so nvcc interleaves the values'
//     dependency chains;
//   * index arithmetic divides by launch constants through a multiply-high
//     (FastDiv), cp.async replaces scalar loads, and the project
//     accumulator and the expand epilogue stay in registers.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "fq_epilogue.cuh"
#include "warp_mma.cuh"

namespace cg = cooperative_groups;

namespace {

// (warps a block, project tiles a warp at most, blocks an SM): eight warps
// with 4 or 8 tiles for the partial-image tiles of the large maps, sixteen
// with 10 for whole images
template <int WARPS, int MAXT>
struct Config {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kBlocksPerSm = WARPS == 16 ? 1 : (MAXT <= 4 ? 3 : 2);
};
constexpr size_t kMaxSmem = 232448;       // 227 KB, the H100's per-block limit

// n / d by a multiply-high with m = floor((2^32 - 1) / d) + 1, exact for
// n * d < 2^32 (every index here is below 2^14, every divisor below 2^8):
// the kernel's index arithmetic divides by launch constants, and an
// integer division costs some twenty instructions.
struct FastDiv {
  uint32_t d, m;
  FastDiv() = default;
  explicit FastDiv(int d_)
      : d(static_cast<uint32_t>(d_)), m(d_ > 1 ? 0xFFFFFFFFu / d_ + 1 : 0) {}
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), m));
  }
};

// Shared-memory layout; mirrors ops/kernels/qblock.BlockTile.smem_bytes.
struct Geometry {
  int th, tw, ph, pw, P, Pp, Kp, R, Rp, hc, cs;
  // divisors of the index arithmetic: pw, tw, Kp / 8, hc / 8, Cout / 8,
  // hc / 4, hc / 16, hc / 2, Cout / 4
  FastDiv f_pw, f_tw, f_kseg, f_hseg, f_cseg, f_hseg4, f_nn, f_npair, f_c4;
  int ldx, ldh, ldw1, ldw2, ldp;            // row lengths, in elements
  // offsets: the ring and its stage; w2, taps within a stage; hs, n2s;
  // the partial sums alias the ring, hs and n2s after the last chunk
  size_t ring, stage, w2, taps, hs, n2, bytes;
};

inline size_t align128(size_t v) { return (v + 127) / 128 * 128; }
inline int round16(int v) { return (v + 15) / 16 * 16; }

Geometry make_geometry(int stride, int cin, int cout, int expand, int th,
                       int tw, int cs, int hc) {
  Geometry g{};
  g.th = th;
  g.tw = tw;
  g.cs = cs;
  g.hc = hc;
  g.ph = (th - 1) * stride + 3;
  g.pw = (tw - 1) * stride + 3;
  g.P = g.ph * g.pw;
  g.Pp = round16(g.P);
  g.Kp = round16(cin);
  g.R = th * tw;
  g.Rp = round16(g.R);
  g.ldx = g.Kp + 8;
  g.ldh = hc + 8;
  g.ldw1 = hc + 8;
  g.ldw2 = cout + 8;
  g.ldp = cout + 4;
  g.f_pw = FastDiv(g.pw);
  g.f_tw = FastDiv(tw);
  g.f_kseg = FastDiv(g.Kp / 8);
  g.f_hseg = FastDiv(hc / 8);
  g.f_cseg = FastDiv(cout / 8);
  g.f_hseg4 = FastDiv(hc / 4);
  g.f_nn = FastDiv(hc / 16);
  g.f_npair = FastDiv(hc / 2);
  g.f_c4 = FastDiv(cout / 4);
  g.ring = align128(static_cast<size_t>(g.Pp) * g.ldx * 2);
  g.w2 = expand ? static_cast<size_t>(g.Kp) * g.ldw1 * 2 : 0;
  g.taps = g.w2 + static_cast<size_t>(hc) * g.ldw2 * 2;
  // nine tap rows, then scale1, shift1, scale_d, shift_d: 13 rows of hc
  g.stage = align128(g.taps + static_cast<size_t>(13) * hc * 4);
  g.hs = g.ring + 2 * g.stage;
  g.n2 = g.hs + (expand ? align128(static_cast<size_t>(g.Pp) * g.ldh * 2) : 0);
  const size_t end = g.n2 + align128(static_cast<size_t>(g.Rp) * g.ldh * 2);
  g.bytes = std::max(end, g.ring + static_cast<size_t>(g.Rp) * g.ldp * 4);
  return g;
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w1;
  const float* wd;
  const __nv_bfloat16* w2;
  const float* aconsts;
  const float* vec[4];          // scale1, shift1, scale_d, shift_d
  const float* s2;
  const float* b2;
  const float* xfactor;
  void* out;
  int H, W, Cin, hid, Cout, stride, Ho, Wo, tiles_w;
  int expand, use_res, methods, emit_norm, out_bf16;
};

// One stage's epilogue: y*scale + shift, activation, and the stage's quant
// (fq::quantize_inv: no division per value).
__device__ __forceinline__ float stage(float y, float scale, float shift,
                                       int activation, const fq::InvQuant& q,
                                       bool normalized) {
  y = fq::apply_act(__fadd_rn(__fmul_rn(y, scale), shift), activation);
  return fq::quantize_inv(y, q, normalized);
}

// The quantizer of stage ``row`` (column ``row`` of the (6, 4) constants,
// method bits 2 * row of ``methods``).
__device__ __forceinline__ fq::InvQuant stage_quant(const float* aconsts,
                                                    int methods, int row) {
  return fq::make_inv_quant((methods >> (2 * row)) & 3,
                            fq::load_consts(aconsts, 4, row));
}

// The tile's input pixels and halo, zero outside the image and past Cin.
__device__ __forceinline__ void load_input(__nv_bfloat16* xs,
                                           const Geometry& g, const Args& a,
                                           long long img, int iy0, int ix0) {
  const int segs = g.Kp / 8;
  for (int i = threadIdx.x; i < g.Pp * segs; i += blockDim.x) {
    const int p = g.f_kseg.div(i), c = (i - p * segs) * 8;
    const int py = g.f_pw.div(p), px = p - py * g.pw;
    const int iy = iy0 + py, ix = ix0 + px;
    const bool ok = p < g.P && c < a.Cin && iy >= 0 && iy < a.H && ix >= 0 &&
                    ix < a.W;
    wm::cp_async16(xs + p * g.ldx + c,
                   a.x + (ok ? ((img * a.H + iy) * a.W + ix) * a.Cin + c : 0),
                   ok);
  }
}

// Hidden channels [j0, j0 + vc) into one ring stage: w1 columns, w2 rows,
// taps and folded vectors, zero past vc.
__device__ __forceinline__ void load_chunk(unsigned char* st,
                                           const Geometry& g, const Args& a,
                                           int j0, int vc) {
  const int tid = threadIdx.x;
  if (a.expand) {
    auto* w1s = reinterpret_cast<__nv_bfloat16*>(st);
    const int segs = g.hc / 8;
    for (int i = tid; i < g.Kp * segs; i += static_cast<int>(blockDim.x)) {
      const int k = g.f_hseg.div(i), c = (i - k * segs) * 8;
      const bool ok = k < a.Cin && c < vc;
      wm::cp_async16(w1s + k * g.ldw1 + c,
                     a.w1 + (ok ? static_cast<long long>(k) * a.hid + j0 + c : 0),
                     ok);
    }
  }
  auto* w2s = reinterpret_cast<__nv_bfloat16*>(st + g.w2);
  const int segs2 = a.Cout / 8;
  for (int i = tid; i < g.hc * segs2; i += static_cast<int>(blockDim.x)) {
    const int j = g.f_cseg.div(i), c = (i - j * segs2) * 8;
    const bool ok = j < vc;
    wm::cp_async16(w2s + j * g.ldw2 + c,
                   a.w2 + (ok ? static_cast<long long>(j0 + j) * a.Cout + c : 0),
                   ok);
  }
  float* rows = reinterpret_cast<float*>(st + g.taps);
  const int segs4 = g.hc / 4;
  for (int i = tid; i < 13 * segs4; i += static_cast<int>(blockDim.x)) {
    const int t = g.f_hseg4.div(i), c = (i - t * segs4) * 4;
    const float* src = t < 9 ? a.wd + t * a.hid : a.vec[t - 9];
    const bool ok = c < vc && src != nullptr;
    wm::cp_async16(rows + t * g.hc + c, ok ? src + j0 + c : a.wd, ok);
  }
}

// f(std::integral_constant<int, M>) for the quantizer method's M, so that
// the per-value code of a phase is compiled once per method, branch-free.
template <typename F>
__device__ __forceinline__ void by_method(int method, F&& f) {
  if (method == fq::kQuantFp8)
    f(std::integral_constant<int, fq::kQuantFp8>{});
  else if (method == fq::kQuantIntAsym || method == fq::kQuantIntSym)
    f(std::integral_constant<int, fq::kQuantIntAsym>{});
  else
    f(std::integral_constant<int, fq::kQuantNone>{});
}

// y*scale + shift, relu6 and the normalized quant of method M (the expand
// and dw stages)
template <int M>
__device__ __forceinline__ float relu6_stage(float y, float scale, float shift,
                                             const fq::InvQuant& q) {
  y = fq::apply_act(__fadd_rn(__fmul_rn(y, scale), shift), fq::kActRelu6);
  return fq::quantize_inv_m<M>(y, q, true);
}

// 2. The expand product of one chunk over the tile's input pixels (warps
// take (16-pixel, 16-channel) items), its epilogue on the fragments, 0 for
// pixels outside the image (channels past the chunk's are 0 already: their
// w1 columns and folds are zero-filled), one bf16 store.
template <int WARPS, int M>
__device__ __forceinline__ void expand_chunk(
    const __nv_bfloat16* __restrict__ xs, const __nv_bfloat16* __restrict__ w1s,
    __nv_bfloat16* __restrict__ hs, const float* __restrict__ vec,
    const Geometry& g, const Args& a, int iy0, int ix0, const fq::InvQuant& q) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q4 = lane & 3;
  const int nn = g.hc / 16, items = (g.Pp / 16) * nn;
#pragma unroll 2
  for (int it = warp; it < items; it += WARPS) {
    const int mi = g.f_nn.div(it), ni = it - mi * nn;
    float d[2][4] = {};
#pragma unroll 2
    for (int kc = 0; kc < g.Kp / 16; ++kc) {
      uint32_t af[4], bf[4];
      wm::ldsm_x4(af, xs + (mi * 16 + (lane & 15)) * g.ldx + kc * 16 +
                          (lane >> 4) * 8);
      wm::ldsm_x4_t(bf, w1s + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  g.ldw1 + ni * 16 + (lane >> 4) * 8);
      wm::mma_bf16(d[0], af, bf[0], bf[1]);
      wm::mma_bf16(d[1], af, bf[2], bf[3]);
    }
    float2 sc[2], sh[2];                 // scale1, shift1 of the columns
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = ni * 16 + nt * 8 + 2 * q4;
      sc[nt] = *reinterpret_cast<const float2*>(vec + j);
      sh[nt] = *reinterpret_cast<const float2*>(vec + g.hc + j);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = mi * 16 + gq + 8 * hr;
      const int py = g.f_pw.div(p), px = p - py * g.pw;
      const int iy = iy0 + py, ix = ix0 + px;
      const bool inside = p < g.P && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = ni * 16 + nt * 8 + 2 * q4;
        float h0 = relu6_stage<M>(d[nt][2 * hr], sc[nt].x, sh[nt].x, q);
        float h1 = relu6_stage<M>(d[nt][2 * hr + 1], sc[nt].y, sh[nt].y, q);
        h0 = inside ? h0 : 0.0f;
        h1 = inside ? h1 : 0.0f;
        *reinterpret_cast<uint32_t*>(hs + p * g.ldh + j) = wm::pack_bf16(h0, h1);
      }
    }
  }
}

// 3. The depthwise stencil of one chunk: each of the first (threads /
// npair) * npair threads keeps one channel pair (npair = hc / 2) with its
// nine taps and fold in registers and walks every (threads / npair)-th
// output pixel; rows past the tile's pixels are zeroed.
template <int WARPS, int M>
__device__ __forceinline__ void stencil_chunk(
    const __nv_bfloat16* __restrict__ src, int lds, __nv_bfloat16* __restrict__ n2s,
    const float* __restrict__ taps, const float* __restrict__ vec,
    const Geometry& g, const Args& a, int vc, const fq::InvQuant& q) {
  const int tid = threadIdx.x;
  const int npair = g.hc / 2, o0 = g.f_npair.div(tid);
  const int ostep = WARPS * 32 / npair;
  const int jt = 2 * (tid - o0 * npair);
  const bool jv = jt < vc;
  const int j = jv ? jt : 0;             // past vc: read channel 0, store 0
  float2 w[9];
#pragma unroll
  for (int t = 0; t < 9; ++t)
    w[t] = *reinterpret_cast<const float2*>(taps + t * g.hc + j);
  const float2 sd = *reinterpret_cast<const float2*>(vec + 2 * g.hc + j);
  const float2 bd = *reinterpret_cast<const float2*>(vec + 3 * g.hc + j);
#pragma unroll 2
  for (int o = o0; o0 < ostep && o < g.R; o += ostep) {
    const int oi = g.f_tw.div(o), oj = o - oi * g.tw;
    const __nv_bfloat16* base =
        src + (oi * a.stride * g.pw + oj * a.stride) * lds + j;
    float y0 = 0.0f, y1 = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float2 hv = wm::unpack_bf16(
            *reinterpret_cast<const uint32_t*>(base + (dy * g.pw + dx) * lds));
        const float2 wt = w[dy * 3 + dx];
        const float t0 = __fmul_rn(hv.x, wt.x), t1 = __fmul_rn(hv.y, wt.y);
        y0 = (dy == 0 && dx == 0) ? t0 : __fadd_rn(y0, t0);
        y1 = (dy == 0 && dx == 0) ? t1 : __fadd_rn(y1, t1);
      }
    float n0 = relu6_stage<M>(y0, sd.x, bd.x, q);
    float n1 = relu6_stage<M>(y1, sd.y, bd.y, q);
    n0 = jv ? n0 : 0.0f;
    n1 = jv ? n1 : 0.0f;
    *reinterpret_cast<uint32_t*>(n2s + o * g.ldh + jt) = wm::pack_bf16(n0, n1);
  }
  for (int i = tid; i < (g.Rp - g.R) * npair; i += WARPS * 32) {
    const int o = g.R + g.f_npair.div(i);
    *reinterpret_cast<uint32_t*>(n2s + o * g.ldh + 2 * (i - (o - g.R) * npair)) = 0u;
  }
}

template <int WARPS, int MAXT>
__global__ void __launch_bounds__(Config<WARPS, MAXT>::kThreads,
                                  Config<WARPS, MAXT>::kBlocksPerSm)
qblock_kernel(const Args a, const Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* hs = reinterpret_cast<__nv_bfloat16*>(smem + g.hs);
  auto* n2s = reinterpret_cast<__nv_bfloat16*>(smem + g.n2);
  float* part = reinterpret_cast<float*>(smem + g.ring);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q4 = lane & 3;

  const int rank = blockIdx.x;                       // in the cluster
  const int ty = blockIdx.y / a.tiles_w, tx = blockIdx.y - ty * a.tiles_w;
  const int oy0 = ty * g.th, ox0 = tx * g.tw;
  const long long img = blockIdx.z;
  const int iy0 = oy0 * a.stride - 1, ix0 = ox0 * a.stride - 1;

  // the rank's slice of the hidden channels, in units of 16
  const int units = (a.hid + 15) / 16;
  const int c_lo = 16 * (rank * units / g.cs);
  const int c_hi = min(16 * ((rank + 1) * units / g.cs), a.hid);
  const int nchunks = c_hi > c_lo ? (c_hi - c_lo + g.hc - 1) / g.hc : 0;

  // the warp's project tiles: a run of the row-major (m16, n8) tiles
  const int nt8 = a.Cout / 8, ntiles = (g.Rp / 16) * nt8;
  const int tpw = (ntiles + WARPS - 1) / WARPS;
  const int t_first = warp * tpw;
  const int t_count = max(0, min(tpw, ntiles - t_first));
  float acc[MAXT][4];
#pragma unroll
  for (int t = 0; t < MAXT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;

  load_input(xs, g, a, img, iy0, ix0);
  load_chunk(smem + g.ring, g, a, c_lo, min(g.hc, c_hi - c_lo));
  wm::cp_async_commit();

  for (int ch = 0; ch < nchunks; ++ch) {
    const int j0 = c_lo + ch * g.hc, vc = min(g.hc, c_hi - j0);
    const unsigned char* st = smem + g.ring + (ch & 1) * g.stage;
    wm::cp_async_wait<0>();              // chunk ch, issued a chunk ago
    __syncthreads();                     // has landed for every thread, and
                                         // chunk ch - 1 is done with its
                                         // stage, hs and n2s
    if (ch + 1 < nchunks) {              // the next chunk under this one
      load_chunk(smem + g.ring + ((ch + 1) & 1) * g.stage, g, a, j0 + g.hc,
                 min(g.hc, c_hi - j0 - g.hc));
      wm::cp_async_commit();
    }
    const float* taps = reinterpret_cast<const float*>(st + g.taps);
    const float* vec = taps + 9 * g.hc;  // scale1, shift1, scale_d, shift_d

    // 2. the expanded chunk of the tile's input pixels, 0 outside the image
    if (a.expand) {
      const fq::InvQuant q_exp = stage_quant(a.aconsts, a.methods, 0);
      by_method(q_exp.method, [&](auto m) {
        expand_chunk<WARPS, decltype(m)::value>(
            xs, reinterpret_cast<const __nv_bfloat16*>(st), hs, vec, g, a, iy0,
            ix0, q_exp);
      });
    }
    __syncthreads();

    // 3. the depthwise stencil on the chunk
    {
      const fq::InvQuant q_dw = stage_quant(a.aconsts, a.methods, 1);
      by_method(q_dw.method, [&](auto m) {
        stencil_chunk<WARPS, decltype(m)::value>(
            a.expand ? hs : xs + j0, a.expand ? g.ldh : g.ldx, n2s, taps, vec,
            g, a, vc, q_dw);
      });
    }
    __syncthreads();

    // 4. the project product of the chunk into the register accumulators
    {
      const auto* w2s = reinterpret_cast<const __nv_bfloat16*>(st + g.w2);
      for (int kc = 0; kc < (vc + 15) / 16; ++kc) {
        int m = t_first / nt8, n = t_first - m * nt8, cur = -1;
        uint32_t af[4];
#pragma unroll
        for (int t = 0; t < MAXT; ++t) {
          if (t < t_count) {
            if (m != cur) {
              wm::ldsm_x4(af, n2s + (m * 16 + (lane & 15)) * g.ldh + kc * 16 +
                                  (lane >> 4) * 8);
              cur = m;
            }
            uint32_t bf[2];
            wm::ldsm_x2_t(bf, w2s + (kc * 16 + (lane & 15)) * g.ldw2 + n * 8);
            wm::mma_bf16(acc[t], af, bf[0], bf[1]);
            if (++n == nt8) {
              n = 0;
              ++m;
            }
          }
        }
      }
    }
  }
  __syncthreads();                       // the partials overwrite the ring

  // 5. partial sums to shared memory (over the ring), then the epilogue
  {
    int m = t_first / nt8, n = t_first - m * nt8;
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (t < t_count) {
        float* p0 = part + (m * 16 + gq) * g.ldp + n * 8 + 2 * q4;
        *reinterpret_cast<float2*>(p0) = make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(p0 + 8 * g.ldp) = make_float2(acc[t][2], acc[t][3]);
        if (++n == nt8) {
          n = 0;
          ++m;
        }
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (g.cs > 1)
    cluster.sync();                      // every rank's partials are written
  else
    __syncthreads();

  const float xf = *a.xfactor;
  const fq::InvQuant q_proj = stage_quant(a.aconsts, a.methods, 2);
  const fq::InvQuant q_blk = stage_quant(a.aconsts, a.methods, 3);
  const int r0 = rank * g.R / g.cs, r1 = (rank + 1) * g.R / g.cs;
  const int c4 = a.Cout / 4;
  for (int i = tid; i < (r1 - r0) * c4; i += WARPS * 32) {
    const int q = g.f_c4.div(i), o = r0 + q, c = 4 * (i - q * c4);
    const int oi = g.f_tw.div(o), oj = o - oi * g.tw;
    const int oh = oy0 + oi, ow = ox0 + oj;
    if (oh >= a.Ho || ow >= a.Wo) continue;
    const int off = o * g.ldp + c;
    // rank 0's partials first, then the others in rank order
    float4 s = *reinterpret_cast<const float4*>(
        (g.cs > 1 ? cluster.map_shared_rank(part, 0) : part) + off);
    {
      for (int k = 1; k < g.cs; ++k) {
        const float4 r =
            *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, k) + off);
        s = make_float4(__fadd_rn(s.x, r.x), __fadd_rn(s.y, r.y),
                        __fadd_rn(s.z, r.z), __fadd_rn(s.w, r.w));
      }
    }
    const float4 sc = __ldg(reinterpret_cast<const float4*>(a.s2 + c));
    const float4 sh = __ldg(reinterpret_cast<const float4*>(a.b2 + c));
    float y[4] = {s.x, s.y, s.z, s.w};
    const float scv[4] = {sc.x, sc.y, sc.z, sc.w}, shv[4] = {sh.x, sh.y, sh.z, sh.w};
    float xr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (a.use_res) {
      const uint2 xv = *reinterpret_cast<const uint2*>(
          xs + ((oi + 1) * g.pw + oj + 1) * g.ldx + c);
      const float2 x01 = wm::unpack_bf16(xv.x), x23 = wm::unpack_bf16(xv.y);
      xr[0] = x01.x;
      xr[1] = x01.y;
      xr[2] = x23.x;
      xr[3] = x23.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (a.use_res) {
        y[e] = stage(y[e], scv[e], shv[e], fq::kActNone, q_proj, false);
        y[e] = __fadd_rn(y[e], __fmul_rn(xr[e], xf));
        y[e] = fq::quantize_inv(y[e], q_blk, a.emit_norm);
      } else {
        y[e] = stage(y[e], scv[e], shv[e], fq::kActNone, q_proj, a.emit_norm);
      }
    }
    const long long idx = ((img * a.Ho + oh) * a.Wo + ow) * a.Cout + c;
    if (a.out_bf16)
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + idx) =
          make_uint2(wm::pack_bf16(y[0], y[1]), wm::pack_bf16(y[2], y[3]));
    else
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + idx) =
          make_float4(y[0], y[1], y[2], y[3]);
  }
  if (g.cs > 1) cluster.sync();          // no rank leaves while read
}

template <int WARPS, int MAXT>
int launch(const Args& a, const Geometry& g, int N, int tiles,
           cudaStream_t stream) {
  auto kernel = qblock_kernel<WARPS, MAXT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>(g.cs), static_cast<unsigned>(tiles),
                     static_cast<unsigned>(N));
  cfg.blockDim = dim3(Config<WARPS, MAXT>::kThreads);
  cfg.dynamicSmemBytes = g.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(g.cs);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = g.cs > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// th x tw output pixels a cluster, cs blocks a cluster each with a slice of
// hid, chunks of hc hidden channels, blocks of ``warps`` warps with maxt
// project tiles a warp at most (8 and 4 or 8, or 16 and 10):
// ops/kernels/qblock.block_tile.
extern "C" int qblock_launch(const void* x, const void* w1, const float* wd,
                             const void* w2, const float* aconsts,
                             const float* s1, const float* b1,
                             const float* sd, const float* bd,
                             const float* s2, const float* b2,
                             const float* xfactor, void* out, int N, int H,
                             int W, int Cin, int hid, int Cout, int stride,
                             int expand, int use_res, int methods,
                             int emit_norm, int out_bf16, int th, int tw,
                             int cs, int hc, int warps, int maxt,
                             void* stream) {
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const Geometry g = make_geometry(stride, Cin, Cout, expand, th, tw, cs, hc);
  const int ntiles = (g.Rp / 16) * (Cout / 8);
  const bool ok = Cin % 8 == 0 && hid % 8 == 0 && Cout % 8 == 0 &&
                  (expand || hid == Cin) && th >= 1 && tw >= 1 &&
                  cs >= 1 && cs <= 4 && cs <= (hid + 15) / 16 && hc % 16 == 0 &&
                  hc % 16 == 0 && hc >= 16 && hc <= 64 && (warps == 8 || warps == 16) &&
                  (ntiles + warps - 1) / warps <= maxt && g.bytes <= kMaxSmem;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = (Wo + tw - 1) / tw;
  const int tiles = ((Ho + th - 1) / th) * tiles_w;
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const __nv_bfloat16*>(w1),
               wd,
               static_cast<const __nv_bfloat16*>(w2),
               aconsts,
               {s1, b1, sd, bd},
               s2,
               b2,
               xfactor,
               out,
               H, W, Cin, hid, Cout, stride, Ho, Wo, tiles_w,
               expand, use_res, methods, emit_norm, out_bf16};
  auto s = static_cast<cudaStream_t>(stream);
  if (warps == 16 && maxt == 10) return launch<16, 10>(a, g, N, tiles, s);
  if (warps == 8 && maxt == 4) return launch<8, 4>(a, g, N, tiles, s);
  if (warps == 8 && maxt == 8) return launch<8, 8>(a, g, N, tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

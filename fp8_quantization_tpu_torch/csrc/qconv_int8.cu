// Int8 3x3 SAME conv for Hopper: a halo-tiled implicit s8 GEMM + exact
// corrections.
//
// Replaces _qconv3x3_int8_kernel of fp8_quantization_tpu/ops/pallas/
// qconv.py (line 278, pallas_call at line 442).  The Pallas kernel builds an
// s8 im2col of whole images in VMEM; here each CTA owns a TH x TW tile of
// output pixels of one image (GEMM rows, BM = 64 or 128 of them, TH*TW <=
// BM) and BN = 64 or 128 output channels, all chosen per launch by the
// wrapper (ops/kernels/qconv_int8.py:conv_tile).  K = 9*Cin (column k is tap
// (dy, dx) = divmod(k / Cin, 3) and channel k % Cin) runs over chunks of 32
// input channels.  For each chunk the CTA stages the input patch under its
// tile, ((TH-1)*s + 3) x ((TW-1)*s + 3) pixels x 32 channels: each float32
// value is read once with 16-byte loads, quantized once on the asymmetric
// grid (i8::quant_x: the IEEE division, rintf and clip of the plain
// version) and stored as xs = xint - 128; a pixel outside the image holds
// zp - 128, the real zero, so the rowsum is the 3x3 window sum padding
// included and the identity holds per output.  The nine taps then read
// their A rows from the patch at tap offsets (implicit im2col in shared
// memory, ldmatrix on per-lane row addresses) into
// mma.sync.m16n8k32.s8.s8.s32.  Stride 2 is index arithmetic.  w is the
// (Cout, 9*Cin) matrix, row-major: the baked int8 grid, staged by 16-byte
// cp.async into a double buffer while the previous chunk's products run,
// or float32 quantized per output channel while it is staged.  The row sum
// comes from per-pixel channel sums of the staged patch, the column sum
// from the staged weights (dp4a); the exact int64 total and the float
// epilogue are int8_epilogue.cuh's, unchanged.
//
// Bound on the card: the kernel reads float32 activations and writes
// float32 outputs, and at 1,979 TOP/s the s8 products are cheap next to
// those bytes: every ResNet-18 shape but the last (7x7x512, bound by
// operations) is bound by bytes, and so is their sum over a forward, so
// the tensor-core rate is not what holds it back and mma.sync suffices.
// What the design does about the bytes: each input value is read and
// divided once per CTA (the earlier design did both once per tap, 9x),
// with the halo (1.1-1.7x the input pixels a tile needs at ResNet-18's
// shapes) and one re-read per 128-channel output tile as the remaining
// overhead, and each output is written once.  What still holds it back
// (ops/kernels/variants.py removes one phase at a time on the card): the
// chunk loop is serial within a CTA (load, barrier, quantize, barrier,
// products) and only one or two CTAs fit on an SM, so the IEEE division
// of every input value, the products and the int64 epilogue each sit on
// the critical path (PERF.md section 6).
// Left for later: reading the bf16 Factored input in place of float32,
// warp-specialized loading, a persistent scheduler that keeps a patch for
// all output-channel tiles, s8 wgmma, TMA for the patch.
#include "int8_epilogue.cuh"

namespace {

constexpr int THREADS = 256, CK = 32;   // threads; input channels a chunk
constexpr int UNITS_PER_TAP = 2;        // 16-byte planes of a 32-channel run

struct Geometry {
  int Nimg, H, W, Cin, Cout, stride, Ho, Wo, th, tw, ph, pw, P, tiles_x,
      tiles;
};

// Shared-memory plan: the float32 patch of the chunk in flight [P][32],
// two quantized patch buffers [plane 2][P][16 B], two weight buffers
// [tap 9][plane 2][BN][16 B], then the per-pixel channel sums, the row
// and column sums.
struct Plan {
  int raw_bytes, patch_bytes, w_bytes, patch_off, w_off, pixsum_off,
      rowsum_off, colsum_off, total;
  __host__ __device__ Plan(int P, int BM, int BN) {
    raw_bytes = P * CK * 4;
    patch_bytes = (2 * 16 * P + 127) / 128 * 128;
    w_bytes = 9 * 2 * BN * 16;
    patch_off = raw_bytes;
    w_off = patch_off + 2 * patch_bytes;
    pixsum_off = w_off + 2 * w_bytes;
    rowsum_off = pixsum_off + (4 * P + 15) / 16 * 16;
    colsum_off = rowsum_off + 4 * BM;
    total = colsum_off + 4 * BN;
  }
};

using i8::cp_async16;
using i8::ldmatrix_x4;
using i8::mma_s8;
using i8::pack4;
using i8::saddr;

// The float32 patch of chunk c0 by 16-byte cp.async, eight per pixel
// (four channels each); pixels outside the image and channels past Cin
// are zero-filled here and replaced in quantize_patch.
__device__ __forceinline__ void stage_raw(float* __restrict__ raw,
                                          const float* __restrict__ x,
                                          long long img_base, int iy0, int ix0,
                                          int c0, const Geometry& g, int tid) {
  const uint32_t base = saddr(raw);
  for (int item = tid; item < g.P * 8; item += THREADS) {
    const int pix = item >> 3, q = item & 7, ci = c0 + 4 * q;
    const int py = pix / g.pw, px = pix - py * g.pw;
    const int iy = iy0 + py, ix = ix0 + px;
    const bool ok = ci < g.Cin && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const float* src =
        ok ? x + img_base + (static_cast<long long>(iy) * g.W + ix) * g.Cin + ci
           : x;
    cp_async16(base + item * 16, src, ok);
  }
}

// The staged float32 patch quantized once into s8 planes (channels 0-15,
// 16-31 of the chunk): xs = xint - 128, zp - 128 outside the image, 0 past
// Cin; the owner lane (q == 0) of each pixel keeps its channel sum.
__device__ __forceinline__ void quantize_patch(
    const float* __restrict__ raw, int8_t* __restrict__ patch,
    int* __restrict__ pixsum, bool first, int iy0, int ix0, int c0,
    const Geometry& g, const i8::Params& p, int tid) {
  const int q = tid & 7, ci = c0 + 4 * q;
  const bool ch_ok = ci < g.Cin;   // Cin % 16 == 0: a group is all in or out
  const int pad = p.zp - 128;
  const unsigned group = 0xFFu << ((tid & 31) & ~7);
  int8_t* dst_plane = patch + (q >> 2) * g.P * 16 + (q & 3) * 4;
  for (int pix = tid >> 3; pix < g.P; pix += THREADS / 8) {
    const int py = pix / g.pw, px = pix - py * g.pw;
    const int iy = iy0 + py, ix = ix0 + px;
    int v0 = 0, v1 = 0, v2 = 0, v3 = 0;
    if (ch_ok) {
      if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
        const float4 f = reinterpret_cast<const float4*>(raw)[pix * 8 + q];
        v0 = i8::quant_x(f.x, p);
        v1 = i8::quant_x(f.y, p);
        v2 = i8::quant_x(f.z, p);
        v3 = i8::quant_x(f.w, p);
      } else {
        v0 = v1 = v2 = v3 = pad;
      }
    }
    *reinterpret_cast<uint32_t*>(dst_plane + pix * 16) = pack4(v0, v1, v2, v3);
    int s = v0 + v1 + v2 + v3;
    s += __shfl_xor_sync(group, s, 1);
    s += __shfl_xor_sync(group, s, 2);
    s += __shfl_xor_sync(group, s, 4);
    if (q == 0) pixsum[pix] = first ? s : pixsum[pix] + s;
  }
}

// The weights of chunk c0 for columns n0..n0+BN: unit u is (tap, plane,
// column) with the column fastest, 16 bytes each.
template <int BN>
__device__ __forceinline__ void stage_w(int8_t* __restrict__ wbuf,
                                        const int8_t* __restrict__ w, int n0,
                                        int c0, const Geometry& g, int tid,
                                        const float*, const i8::Params&) {
  const uint32_t base = saddr(wbuf);
  const long long K = 9LL * g.Cin;
  for (int u = tid; u < 9 * UNITS_PER_TAP * BN; u += THREADS) {
    const int n = u % BN, tp = u / BN, tap = tp >> 1, c = c0 + (tp & 1) * 16;
    const bool ok = n0 + n < g.Cout && c < g.Cin;
    const int8_t* src = ok ? w + (n0 + n) * K + tap * g.Cin + c : w;
    cp_async16(base + u * 16, src, ok);
  }
}

template <int BN>
__device__ __forceinline__ void stage_w(int8_t* __restrict__ wbuf,
                                        const float* __restrict__ w, int n0,
                                        int c0, const Geometry& g, int tid,
                                        const float* __restrict__ w_delta,
                                        const i8::Params& p) {
  const long long K = 9LL * g.Cin;
  for (int u = tid; u < 9 * UNITS_PER_TAP * BN; u += THREADS) {
    const int n = u % BN, tp = u / BN, tap = tp >> 1, c = c0 + (tp & 1) * 16;
    uint32_t word[4] = {0, 0, 0, 0};
    if (n0 + n < g.Cout && c < g.Cin) {
      const float dw = fmaxf(w_delta[n0 + n], 1e-8f);
      const float* src = w + (n0 + n) * K + tap * g.Cin + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src + 4 * e));
        word[e] = pack4(i8::quant_w(f.x, dw, p), i8::quant_w(f.y, dw, p),
                        i8::quant_w(f.z, dw, p), i8::quant_w(f.w, dw, p));
      }
    }
    *reinterpret_cast<uint4*>(wbuf + u * 16) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

template <int BM, int BN, typename WT>
__global__ void __launch_bounds__(THREADS)
qconv3x3_int8_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                     const float* __restrict__ w_delta,
                     const float* __restrict__ w_scalars,
                     const float* __restrict__ a_scalars,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ out,
                     const Geometry g, int a_bits, int w_bits,
                     int activation) {
  constexpr int WARPS_M = BM / 32, WARPS_N = 8 / WARPS_M, WN = BN / WARPS_N;
  constexpr int NB = WN / 8;   // n8 blocks a warp
  extern __shared__ __align__(128) uint8_t smem[];
  const Plan plan(g.P, BM, BN);
  float* raw = reinterpret_cast<float*>(smem);
  // buffer b of the quantized patch / the weights
  auto patch = [&](int b) {
    return reinterpret_cast<int8_t*>(smem + plan.patch_off +
                                     b * plan.patch_bytes);
  };
  auto wbuf = [&](int b) {
    return reinterpret_cast<int8_t*>(smem + plan.w_off + b * plan.w_bytes);
  };
  int* pixsum = reinterpret_cast<int*>(smem + plan.pixsum_off);
  int* s_rowsum = reinterpret_cast<int*>(smem + plan.rowsum_off);
  int* s_colsum = reinterpret_cast<int*>(smem + plan.colsum_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % WARPS_M, warp_n = warp / WARPS_M;
  const int img = blockIdx.x / g.tiles, t = blockIdx.x - img * g.tiles;
  const int oy0 = (t / g.tiles_x) * g.th, ox0 = (t % g.tiles_x) * g.tw;
  const int n0 = blockIdx.y * BN, s = g.stride;
  const long long img_base = static_cast<long long>(img) * g.H * g.W * g.Cin;
  const int iy0 = oy0 * s - 1, ix0 = ox0 * s - 1;
  const i8::Params p = i8::load_params(a_scalars, w_scalars, a_bits, w_bits);
  if (tid < BN) s_colsum[tid] = 0;

  // Patch pixel of this lane's A rows (ldmatrix: lanes 0-15 rows 0-15 of
  // plane 0, lanes 16-31 the same rows of plane 1); rows past the tile
  // read pixel 0 and are never stored.
  int rowpix[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp_m * 32 + i * 16 + (lane & 15);
    rowpix[i] = r < g.th * g.tw ? (r / g.tw) * s * g.pw + (r % g.tw) * s : 0;
  }
  const uint32_t a_lane = (lane >> 4) * g.P * 16;
  // B rows (output channels) of this lane's ldmatrix: lanes 0-7 / 16-23
  // columns 0-7 / 8-15 of an n16 pair, plane (lane >> 3) & 1.
  const uint32_t b_lane =
      (((lane >> 3) & 1) * BN + warp_n * WN + (lane & 7) + ((lane >> 4) << 3)) *
      16;

  int acc[2][NB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // colsum: thread t sums column t % BN over the units (tap, plane)
  // congruent to t / BN
  constexpr int CS_PARTS = THREADS / BN;
  const int cs_col = tid % BN, cs_part = tid / BN;
  int colsum = 0;

  // Chunk c + 1's copies (cp.async) run under chunk c's products; then
  // it is quantized from the float32 patch into the other patch buffer.
  const int nch = (g.Cin + CK - 1) / CK;
  stage_raw(raw, x, img_base, iy0, ix0, 0, g, tid);
  stage_w<BN>(wbuf(0), w, n0, 0, g, tid, w_delta, p);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  quantize_patch(raw, patch(0), pixsum, true, iy0, ix0, 0, g, p, tid);
  __syncthreads();

  for (int c = 0; c < nch; ++c) {
    const int cur = c & 1;
    const bool next = c + 1 < nch;
    if (next) {
      stage_raw(raw, x, img_base, iy0, ix0, (c + 1) * CK, g, tid);
      stage_w<BN>(wbuf(cur ^ 1), w, n0, (c + 1) * CK, g, tid, w_delta, p);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const uint4* wv = reinterpret_cast<const uint4*>(wbuf(cur));
    for (int tp = cs_part; tp < 9 * UNITS_PER_TAP; tp += CS_PARTS) {
      const uint4 u = wv[tp * BN + cs_col];
      colsum = __dp4a(static_cast<int>(u.x), 0x01010101, colsum);
      colsum = __dp4a(static_cast<int>(u.y), 0x01010101, colsum);
      colsum = __dp4a(static_cast<int>(u.z), 0x01010101, colsum);
      colsum = __dp4a(static_cast<int>(u.w), 0x01010101, colsum);
    }
    const uint32_t pa = saddr(patch(cur)) + a_lane;
    const uint32_t pb = saddr(wbuf(cur)) + b_lane;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * g.pw + tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], pa + (rowpix[i] + toff) * 16);
#pragma unroll
      for (int jp = 0; jp < NB / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, pb + (tap * 2 * BN + jp * 16) * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (next) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();   // chunk c + 1 landed; patch(cur ^ 1) is free
      quantize_patch(raw, patch(cur ^ 1), pixsum, false, iy0, ix0,
                     (c + 1) * CK, g, p, tid);
      __syncthreads();   // chunk c + 1 quantized; raw is free
    }
  }
  __syncthreads();
  atomicAdd(&s_colsum[cs_col], colsum);
  if (tid < BM) {
    int rs = 0;
    if (tid < g.th * g.tw) {
      const int base = (tid / g.tw) * s * g.pw + (tid % g.tw) * s;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        rs += pixsum[base + (tap / 3) * g.pw + tap % 3];
    }
    s_rowsum[tid] = rs;
  }
  __syncthreads();

  const int K = 9 * g.Cin;
  const bool pairs = (g.Cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int cl = warp_n * WN + j * 8 + 2 * (lane & 3), n = n0 + cl;
    if (n >= g.Cout) continue;
    const bool two = n + 1 < g.Cout;
    float dw[2], sc[2], sh[2];
    int cs[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = two ? e : 0;
      dw[e] = fmaxf(w_delta[n + cc], 1e-8f);
      sc[e] = scale[n + cc];
      sh[e] = shift[n + cc];
      cs[e] = s_colsum[cl + cc];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp_m * 32 + i * 16 + (lane >> 2) + 8 * h;
        if (r >= g.th * g.tw) continue;
        const int oy = oy0 + r / g.tw, ox = ox0 + r % g.tw;
        if (oy >= g.Ho || ox >= g.Wo) continue;
        const long long o =
            ((static_cast<long long>(img) * g.Ho + oy) * g.Wo + ox) * g.Cout + n;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y[e] = i8::epilogue(acc[i][j][2 * h + e], s_rowsum[r], cs[e], K, p,
                              dw[e], sc[e], sh[e], activation);
        if (two && pairs) {
          *reinterpret_cast<float2*>(out + o) = make_float2(y[0], y[1]);
        } else {
          out[o] = y[0];
          if (two) out[o + 1] = y[1];
        }
      }
  }
}

template <int BM, int BN, typename WT>
int launch(const float* x, const void* w, const float* w_delta,
           const float* w_scalars, const float* a_scalars, const float* scale,
           const float* shift, float* out, const Geometry& g, int a_bits,
           int w_bits, int activation, cudaStream_t stream) {
  auto kernel = qconv3x3_int8_kernel<BM, BN, WT>;
  const int smem = Plan(g.P, BM, BN).total;
  static int attribute_bytes = 48 * 1024;
  if (smem > attribute_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_bytes = smem;
  }
  const dim3 grid(static_cast<unsigned>(g.Nimg) * g.tiles,
                  (g.Cout + BN - 1) / BN);
  kernel<<<grid, THREADS, smem, stream>>>(
      x, static_cast<const WT*>(w), w_delta, w_scalars, a_scalars, scale,
      shift, out, g, a_bits, w_bits, activation);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN>
int launch_w(bool w_int8, const float* x, const void* w, const float* w_delta,
             const float* w_scalars, const float* a_scalars,
             const float* scale, const float* shift, float* out,
             const Geometry& g, int a_bits, int w_bits, int activation,
             cudaStream_t stream) {
  if (w_int8)
    return launch<BM, BN, int8_t>(x, w, w_delta, w_scalars, a_scalars, scale,
                                  shift, out, g, a_bits, w_bits, activation,
                                  stream);
  return launch<BM, BN, float>(x, w, w_delta, w_scalars, a_scalars, scale,
                               shift, out, g, a_bits, w_bits, activation,
                               stream);
}

}  // namespace

// bm, th, tw, bn: the tile (ops/kernels/qconv_int8.py:conv_tile): bm 64
// or 128 GEMM rows holding a th x tw block of output pixels (th*tw <= bm),
// bn 64 or 128 output channels.  Cin % 16 == 0, x and w 16-byte aligned.
extern "C" int qconv3x3_int8_launch(const float* x, const void* w, int w_int8,
                                    const float* w_delta,
                                    const float* w_scalars,
                                    const float* a_scalars,
                                    const float* scale, const float* shift,
                                    float* out, int N, int H, int W, int Cin,
                                    int Cout, int stride, int a_bits,
                                    int w_bits, int activation, int bm, int th,
                                    int tw, int bn, void* stream) {
  if (th < 1 || tw < 1 || th * tw > bm || Cin % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.Nimg = N; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout; g.stride = stride;
  g.Ho = (H - 1) / stride + 1;
  g.Wo = (W - 1) / stride + 1;
  g.th = th; g.tw = tw;
  g.ph = (th - 1) * stride + 3;
  g.pw = (tw - 1) * stride + 3;
  g.P = g.ph * g.pw;
  g.tiles_x = (g.Wo + tw - 1) / tw;
  g.tiles = ((g.Ho + th - 1) / th) * g.tiles_x;
  auto st = static_cast<cudaStream_t>(stream);
  const bool i8w = w_int8 != 0;
  if (bm == 128 && bn == 128)
    return launch_w<128, 128>(i8w, x, w, w_delta, w_scalars, a_scalars, scale,
                              shift, out, g, a_bits, w_bits, activation, st);
  if (bm == 128 && bn == 64)
    return launch_w<128, 64>(i8w, x, w, w_delta, w_scalars, a_scalars, scale,
                             shift, out, g, a_bits, w_bits, activation, st);
  if (bm == 64 && bn == 128)
    return launch_w<64, 128>(i8w, x, w, w_delta, w_scalars, a_scalars, scale,
                             shift, out, g, a_bits, w_bits, activation, st);
  if (bm == 64 && bn == 64)
    return launch_w<64, 64>(i8w, x, w, w_delta, w_scalars, a_scalars, scale,
                            shift, out, g, a_bits, w_bits, activation, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Fused depthwise 3x3 SAME conv for Hopper: 9-tap stencil + epilogue +
// output quant.
//
// Replaces _qdwconv3x3_kernel of fp8_quantization_tpu/ops/pallas/qconv.py
// (line 183, pallas_call at line 251).  The Pallas kernel holds whole images
// in VMEM and builds stride 2 from even/odd phase planes.  Here a block owns
// a th x tw output tile of one image and a group of cg x 8 channels (a 3-D
// grid: tiles, channel groups, images; every index in 32 bits, no division
// in a loop).  It stages the tile's (s*(th-1)+3) x (s*(tw-1)+3) input halo
// into shared memory by 16-byte cp.async, SAME padding a zero fill
// (src-size 0), so each input value is read from device memory about once.
// Each thread keeps the 9 x 2 weights of its 2 channels, their scale and
// shift in registers and walks its tile row in strips of kSeg outputs with
// a sliding window of 3 columns: a staged value is read from shared memory
// once per output row that uses it, not nine times.  The nine products are
// summed in float32 in (dy, dx) row-major order, as the Pallas body does
// (qconv.py:203-207).  Each product of a bf16 input and a bf16-exact weight
// has at most 16 significant bits, so it is exact in float32 (above 2^-133)
// and fma(x, w, acc) rounds once, as the plain version's acc + x * w does:
// with -fmad=false and the _rn intrinsics every step is the plain
// version's, bit for bit, in 9 instructions a tap sum instead of 17.  Then
// y*scale + shift, relu/relu6 and the output quant, FP8 or int_asym, by
// the division-free fq::quantize_inv_m (the same values as fq::quantize),
// stored as the normalized bf16 value (emit_norm) or float32.
//
// Bound on the card: bytes, barely.  Per output element it moves 2 bytes
// out and 2*s^2 bytes in (bf16) and issues about 40 instructions by the
// code's count (9 of the stencil, about 20 of the FP8 quant), so at
// stride 1 the instruction issue is about as long as the memory time.
// What the design does about it: 2 channels a thread, not 4 (fewer
// registers, more warps an SM), one thread per tile row walking up to 4
// strips (its weights and constants serve up to 28 outputs), one kernel
// per stride, output method, activation and output type (no branch in the
// epilogue).  The input
// reads, the stencil and the FP8 quant each still cost about a fifth of
// the time and overlap only across the blocks an SM holds (PERF.md
// section 6).  The tile, the channel group and the strip come from
// ops/kernels/qdwconv.py:dw_tile.  Channels that are not a multiple of 8
// take a plain one-thread-per-output route.
#include <type_traits>

#include "fq_epilogue.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int kSeg = 7;           // outputs a thread computes along a row
constexpr int kVec = 2;           // channels a thread computes (2 or 4)
constexpr int kMaxThreads = 512;
constexpr int kSimpleThreads = 256;

struct Args {
  const __nv_bfloat16* x;
  const float* w;
  const float* aconsts;
  const float* scale;
  const float* shift;
  void* out;
  int H, W, C, Ho, Wo, activation;
  bool emit_norm;
  int th, tw, cg, cg_shift;       // tile; 8-channel vectors a block (2^cg_shift)
  int tiles_x, hr, hc, rp;        // halo rows, cols; row pitch in 16-byte pieces
};

// V bf16 values, as stored (4 or 8 bytes)
template <int V>
using RawT = std::conditional_t<V == 4, uint2, uint32_t>;
using Raw = RawT<kVec>;

template <int V>
__device__ __forceinline__ void unpack(RawT<V> raw, float (&v)[V]) {
  if constexpr (V == 4) {
    const float2 a = wm::unpack_bf16(raw.x), b = wm::unpack_bf16(raw.y);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    const float2 a = wm::unpack_bf16(raw);
    v[0] = a.x; v[1] = a.y;
  }
}

// V consecutive floats from p (aligned to V floats)
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x; v[1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(void* out, long long o, const float (&y)[V],
                                          bool bf16_out) {
  if constexpr (V == 4) {
    if (bf16_out)
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) =
          make_uint2(wm::pack_bf16(y[0], y[1]), wm::pack_bf16(y[2], y[3]));
    else
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
          make_float4(y[0], y[1], y[2], y[3]);
  } else {
    if (bf16_out)
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + o) =
          wm::pack_bf16(y[0], y[1]);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y[0], y[1]);
  }
}

template <int S, int METHOD, int ACT, bool NORM>
__global__ void __launch_bounds__(kMaxThreads) qdwconv3x3_kernel(const Args a) {
  extern __shared__ uint4 halo[];     // piece (r, c, v) at r * rp + c * cg + v
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int n = blockIdx.z;
  const int ty = blockIdx.x / a.tiles_x, tx = blockIdx.x - ty * a.tiles_x;
  const int oy0 = ty * a.th, ox0 = tx * a.tw;
  const int c0 = blockIdx.y * a.cg * 8;

  // stage the halo: piece i of the flattened (row, column, vector) range,
  // walked by row and remainder (no division in the loop)
  {
    const __nv_bfloat16* xn = a.x + static_cast<long long>(n) * a.H * a.W * a.C + c0;
    const int per_row = a.hc * a.cg;
    int r = tid / per_row, rem = tid - r * per_row;
    const int dr = nthreads / per_row, drem = nthreads - dr * per_row;
    const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;
    while (r < a.hr) {
      const int c = rem >> a.cg_shift, v = rem & (a.cg - 1);
      const int ih = iy0 + r, iw = ix0 + c;
      const bool ok = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
      const __nv_bfloat16* src =
          ok ? xn + static_cast<long long>(ih * a.W + iw) * a.C + v * 8 : xn;
      wm::cp_async16(halo + r * a.rp + c * a.cg + v, src, ok);
      r += dr;
      rem += drem;
      if (rem >= per_row) { rem -= per_row; ++r; }
    }
    wm::cp_async_commit();
  }

  // thread: channel vector cv (kVec channels), tile row rt; it walks the
  // row's tw / kSeg strips
  constexpr int TPP = 8 / kVec;                    // threads a 16-byte piece
  const int tpv = a.cg * TPP;
  const int cv = tid & (tpv - 1), rt = tid >> (a.cg_shift + (TPP == 4 ? 2 : 1));
  const int ch = c0 + cv * kVec;
  float wr[9][kVec], scv[kVec], shv[kVec];
#pragma unroll
  for (int t = 0; t < 9; ++t) load_vec<kVec>(a.w + t * a.C + ch, wr[t]);
  load_vec<kVec>(a.scale + ch, scv);
  load_vec<kVec>(a.shift + ch, shv);
  const fq::InvQuant q = fq::make_inv_quant(METHOD, fq::load_consts(a.aconsts, 1, 0));

  wm::cp_async_wait<0>();
  __syncthreads();

  const int oh = oy0 + rt;
  if (oh >= a.Ho) return;
  // this thread's kVec channels of halo pixel (row, col), in Raw units
  const Raw* hv = reinterpret_cast<const Raw*>(halo);
  const int rstep = a.rp * TPP, cstep = a.cg * TPP;
  const Raw* hrow = hv + (S * rt) * rstep + cv;
  const long long out_row =
      (static_cast<long long>(n) * a.Ho + oh) * a.Wo * a.C + ch;

  for (int ow0 = ox0; ow0 < ox0 + a.tw && ow0 < a.Wo; ow0 += kSeg) {
    // the window: column k of the strip (halo column S * (ow0 - ox0) + k)
    const Raw* hs = hrow + S * (ow0 - ox0) * cstep;
    constexpr int NCOL = S * (kSeg - 1) + 3;
    float col[NCOL][3][kVec];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
#pragma unroll
      for (int k = (j == 0 ? 0 : S * (j - 1) + 3); k < S * j + 3; ++k)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) unpack<kVec>(hs[dy * rstep + k * cstep], col[k][dy]);
      // the nine taps in (dy, dx) order: each product of a bf16 value and a
      // bf16-exact weight is exact in float32, so fma(x, w, acc) rounds
      // once, as acc + x * w does
      float acc[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        acc[v] = __fmul_rn(col[S * j][0][v], wr[0][v]);
#pragma unroll
        for (int t = 1; t < 9; ++t)
          acc[v] = __fmaf_rn(col[S * j + t % 3][t / 3][v], wr[t][v], acc[v]);
      }
      float y[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        y[v] = fq::quantize_inv_m<METHOD>(
            fq::apply_act(__fadd_rn(__fmul_rn(acc[v], scv[v]), shv[v]), ACT), q, NORM);
      const int ow = ow0 + j;
      if (ow < a.Wo)
        store_vec<kVec>(a.out, out_row + static_cast<long long>(ow) * a.C, y, NORM);
    }
  }
}

// C % 8 != 0: one thread per output value, the nine taps read from device
// memory.
template <int METHOD>
__global__ void __launch_bounds__(kSimpleThreads)
qdwconv3x3_kernel_any_c(const Args a, int stride) {
  const int per_image = a.Ho * a.Wo * a.C;
  const int i = blockIdx.x * kSimpleThreads + threadIdx.x;
  if (i >= per_image) return;
  const int n = blockIdx.y;
  const int c = i % a.C, pix = i / a.C;
  const int ow = pix % a.Wo, oh = pix / a.Wo;
  const __nv_bfloat16* xn = a.x + static_cast<long long>(n) * a.H * a.W * a.C;
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int ih = oh * stride - 1 + dy;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int iw = ow * stride - 1 + dx;
      const bool in_image = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
      const float xv = in_image ? __bfloat162float(xn[(ih * a.W + iw) * a.C + c]) : 0.0f;
      const float term = __fmul_rn(xv, __ldg(a.w + (dy * 3 + dx) * a.C + c));
      acc = (dy == 0 && dx == 0) ? term : __fadd_rn(acc, term);
    }
  }
  const fq::InvQuant q = fq::make_inv_quant(METHOD, fq::load_consts(a.aconsts, 1, 0));
  const float y = fq::quantize_inv_m<METHOD>(
      fq::apply_act(__fadd_rn(__fmul_rn(acc, __ldg(a.scale + c)), __ldg(a.shift + c)),
                    a.activation),
      q, a.emit_norm);
  fq::store_out(a.out, static_cast<long long>(n) * per_image + i, y, a.emit_norm);
}

template <int METHOD, int ACT, bool NORM>
int launch(const Args& a, int N, int stride, cudaStream_t st) {
  const int threads = a.cg * (8 / kVec) * a.th;
  const dim3 grid(a.tiles_x * ((a.Ho + a.th - 1) / a.th), a.C / (8 * a.cg), N);
  const int smem = a.hr * a.rp * 16;
  auto kernel = stride == 1 ? qdwconv3x3_kernel<1, METHOD, ACT, NORM>
                            : qdwconv3x3_kernel<2, METHOD, ACT, NORM>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int METHOD, int ACT>
int dispatch_norm(const Args& a, int N, int stride, cudaStream_t st) {
  if constexpr (METHOD == fq::kQuantNone) return launch<METHOD, ACT, false>(a, N, stride, st);
  else
    return a.emit_norm ? launch<METHOD, ACT, true>(a, N, stride, st)
                       : launch<METHOD, ACT, false>(a, N, stride, st);
}

template <int METHOD>
int dispatch(const Args& a, int N, int stride, cudaStream_t st) {
  if (a.cg == 0) {
    const dim3 grid((a.Ho * a.Wo * a.C + kSimpleThreads - 1) / kSimpleThreads, N);
    qdwconv3x3_kernel_any_c<METHOD><<<grid, kSimpleThreads, 0, st>>>(a, stride);
    return static_cast<int>(cudaGetLastError());
  }
  switch (a.activation) {
    case fq::kActNone: return dispatch_norm<METHOD, fq::kActNone>(a, N, stride, st);
    case fq::kActRelu: return dispatch_norm<METHOD, fq::kActRelu>(a, N, stride, st);
    case fq::kActRelu6: return dispatch_norm<METHOD, fq::kActRelu6>(a, N, stride, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (N, H, W, C) bf16, 16-byte aligned; w (3, 3, C) float32 taps; scale,
// shift (C,); aconsts (6, 1) of a_method (kQuantNone, kQuantFp8 or
// kQuantIntAsym); out (N, Ho, Wo, C) bf16 (emit_norm) or float32.  The
// tile (ops/kernels/qdwconv.py:dw_tile): th x tw outputs (tw a multiple of
// 7) and cg 8-channel vectors a block (a power of two dividing C / 8), or
// cg = 0 for the one-thread-per-output route (any C).
extern "C" int qdwconv3x3_launch(const void* x, const float* w,
                                 const float* aconsts, const float* scale,
                                 const float* shift, void* out, int N, int H,
                                 int W, int C, int stride, int a_method,
                                 int activation, int emit_norm, int th, int tw,
                                 int cg, void* stream) {
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w; a.aconsts = aconsts; a.scale = scale; a.shift = shift; a.out = out;
  a.H = H; a.W = W; a.C = C;
  a.Ho = (H - 1) / stride + 1;
  a.Wo = (W - 1) / stride + 1;
  a.activation = activation;
  a.emit_norm = emit_norm != 0;
  a.th = th; a.tw = tw; a.cg = cg;
  a.cg_shift = 0;
  while ((1 << a.cg_shift) < a.cg) ++a.cg_shift;
  if ((stride != 1 && stride != 2) || (emit_norm && a_method == fq::kQuantNone) ||
      (a.cg != 0 && ((1 << a.cg_shift) != a.cg || C % (8 * a.cg) != 0 || a.th < 1 ||
                     a.tw < kSeg || a.tw % kSeg != 0 ||
                     a.cg * (8 / kVec) * a.th > kMaxThreads)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.tiles_x = a.cg ? (a.Wo + a.tw - 1) / a.tw : 0;
  a.hr = stride * (a.th - 1) + 3;
  a.hc = stride * (a.tw - 1) + 3;
  // row pitch: rows a quarter-warp apart land on other banks where the
  // channel group is narrower than 8 pieces (stride * rp = cg mod 8)
  a.rp = a.hc * a.cg;
  for (int pad = 0; a.cg && a.cg < 8 && pad < 8; ++pad)
    if ((stride * (a.hc * a.cg + pad) - a.cg) % 8 == 0) { a.rp = a.hc * a.cg + pad; break; }
  auto st = static_cast<cudaStream_t>(stream);
  switch (a_method) {
    case fq::kQuantNone: return dispatch<fq::kQuantNone>(a, N, stride, st);
    case fq::kQuantFp8: return dispatch<fq::kQuantFp8>(a, N, stride, st);
    case fq::kQuantIntAsym: return dispatch<fq::kQuantIntAsym>(a, N, stride, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

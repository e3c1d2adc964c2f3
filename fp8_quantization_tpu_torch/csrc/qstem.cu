// Fused ResNet stem for Hopper: conv7x7/2 pad 3 + folded BN + relu +
// maxpool3x3/2 pad 1 + output quant (FP8 or int_asym), in one pass.
//
// Replaces _qstem_kernel of fp8_quantization_tpu/ops/pallas/qstem.py
// (line 88, pallas_call at line 242).  The Pallas kernel walks bands of
// conv rows over whole images in VMEM, carrying one conv row across each
// band seam.  Blocks on the card run in no order, so nothing is carried:
// a tile is tp x tq pooled outputs of one image (ops/kernels/qstem.py:
// stem_tile) and recomputes the (2tp+1) x (2tq+1) conv pixels its pooling
// windows read (the halo).  Blocks are persistent (as many as fit on the
// SMs, two at 8 x 8 tiles) and walk the tiles; each stages the bf16 weight
// matrix once, transposed to the K-major B operand of mma.sync.
//
// No im2col matrix: K is laid out dy-major (ops/kernels/qstem.py:
// weight_matrix), k = dy * runp + dx * cin + ci with the 7 * cin taps of
// one dy padded to an even run (22 for cin = 3, Kp = 160), and the input
// patch is staged as bf16 rows of even pitch.  For conv pixel (r, c) of the
// tile and an even k, the A pair (k, k + 1) of an m16n8k16 fragment is then
// one aligned 32-bit word of the patch, at (2r * pitch + 2c * cin) +
// koff[k], koff[k] = dy * pitch + (k - dy * runp) from a small table.  The
// padded taps have zero weights (they read finite neighbours).
//
// The patch comes in by 16-byte loads (a float32 patch row is contiguous
// in NHWC), SAME padding outside the image's element range of each row
// (no division), and is cast to bf16 as it lands.  The next tile's loads
// are issued into registers before the current tile's products and
// written after them, so they run under the products.  Products are bf16
// with fp32 sums; BN and relu run on the accumulators, conv pixels outside
// the image are set to 0 (the max identity after relu, so the pool's
// padding is exact) and the fp32 conv tile goes to shared memory.  Then the
// 3x3/2 max pool reads it, and after the pool the division-free
// fq::quantize_inv_m of the method (FP8 and integer quantization are
// monotone, so quant(pool(y)) == pool(quant(y)) and 4x fewer values are
// quantized), stored 16 bytes (8 channels) at a time.
//
// Bound on the card: at (64, 224, 224, 3) the conv is 15.1 GFLOP against
// 38.5 MB of float32 input and 25.7 MB of bf16 output, about 0.019 ms of
// bytes and 0.015 ms of bf16 tensor-core work at peak; the shared-memory
// traffic of the B fragments, the pool and the epilogue take the time
// (PERF.md section 6).
#include "fq_epilogue.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int COUT = 64, THREADS = 256, WARPS = THREADS / 32;
constexpr int CSP = COUT + 4;    // conv tile row pitch (floats)
constexpr int MAXCH = 5;         // patch chunks a thread holds across the products

struct Geo {
  const void* x;
  const __nv_bfloat16* w;
  const float* aconsts;
  const float* scale;
  const float* shift;
  void* out;
  int S, cin, C, P;              // input, conv and pooled sizes
  int tp, tq, cr, cc, mp, mtiles;  // pooled tile, its conv rows / cols / pixels
  int ir, iw, pitch, nch;        // patch rows, elements a row, pitch, chunks a row
  int runp, kd, ksteps, wp;      // dy run, K used, k16 steps, W row pitch
  int tiles_x, tiles_y, tiles;
  bool emit_norm;
  int off_ss, off_koff, off_patch, off_cs;   // shared-memory offsets (bytes)
};

// tile t -> (image, first pooled row, first pooled column)
__device__ __forceinline__ void decode(const Geo& g, int t, int& n, int& p0, int& q0) {
  const int per_image = g.tiles_x * g.tiles_y;
  n = t / per_image;
  const int r = t - n * per_image, ty = r / g.tiles_x;
  p0 = ty * g.tp;
  q0 = (r - ty * g.tiles_x) * g.tq;
}

// Patch row pr of the tile at (n, p0, q0): its first element e0 in x (the
// column 4 q0 - 5, may lie left of the image) and the range [lo, hi) of
// elements inside the image (empty above and below it).
struct Span { long long e0, lo, hi; };

__device__ __forceinline__ Span row_span(const Geo& g, int n, int p0, int q0, int pr) {
  const int ih = 4 * p0 - 5 + pr;
  const long long rb = (static_cast<long long>(n) * g.S + ih) * g.S * g.cin;
  Span s;
  s.e0 = rb + static_cast<long long>(4 * q0 - 5) * g.cin;
  s.lo = s.hi = 0;
  if (ih >= 0 && ih < g.S) {
    s.lo = s.e0 > rb ? s.e0 : rb;
    const long long end = rb + static_cast<long long>(g.S) * g.cin;
    s.hi = s.e0 + g.iw < end ? s.e0 + g.iw : end;
  }
  return s;
}

// The raw bits of an input element and their bf16 value
template <typename XT> struct Elem;
template <> struct Elem<float> {
  using Bits = uint32_t;
  static __device__ __forceinline__ __nv_bfloat16 bf16(uint32_t b) {
    return __float2bfloat16_rn(__uint_as_float(b));
  }
};
template <> struct Elem<__nv_bfloat16> {
  using Bits = unsigned short;
  static __device__ __forceinline__ __nv_bfloat16 bf16(unsigned short b) {
    return __ushort_as_bfloat16(b);
  }
};

// Chunk j of a patch row: 16 bytes of x from element base (a multiple of
// 16 / sizeof(XT)), zero outside [lo, hi).
template <typename XT>
__device__ __forceinline__ long long chunk_base(const Span& s, int j) {
  constexpr int LOG = sizeof(XT) == 4 ? 2 : 3;
  return ((s.e0 >> LOG) << LOG) + (static_cast<long long>(j) << LOG);
}

template <typename XT>
__device__ __forceinline__ uint4 fetch(const void* xv, long long base, const Span& s) {
  using B = typename Elem<XT>::Bits;
  constexpr int EPC = 16 / sizeof(XT);
  const B* x = static_cast<const B*>(xv);
  if (base >= s.lo && base + EPC <= s.hi)
    return __ldg(reinterpret_cast<const uint4*>(x + base));
  union { uint4 u; B v[EPC]; } r;
  r.u = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int t = 0; t < EPC; ++t)
    if (base + t >= s.lo && base + t < s.hi) r.v[t] = x[base + t];
  return r.u;
}

// a fetched chunk into patch row pr, cast to bf16, the elements of the row
template <typename XT>
__device__ __forceinline__ void put(const Geo& g, __nv_bfloat16* patch, int pr,
                                    long long base, const Span& s, uint4 raw) {
  using B = typename Elem<XT>::Bits;
  constexpr int EPC = 16 / sizeof(XT);
  union { uint4 u; B v[EPC]; } r;
  r.u = raw;
#pragma unroll
  for (int t = 0; t < EPC; ++t) {
    const long long pe = base + t - s.e0;
    if (pe >= 0 && pe < g.iw)
      patch[pr * g.pitch + static_cast<int>(pe)] = Elem<XT>::bf16(r.v[t]);
  }
}

// chunks [first, ir * nch) of tile (n, p0, q0), every THREADS-th, loaded
// and written now
template <typename XT>
__device__ __forceinline__ void stage_rest(const Geo& g, __nv_bfloat16* patch, int n,
                                           int p0, int q0, int first) {
  for (int i = first; i < g.ir * g.nch; i += THREADS) {
    const int pr = i / g.nch;
    const Span s = row_span(g, n, p0, q0, pr);
    const long long base = chunk_base<XT>(s, i - pr * g.nch);
    put<XT>(g, patch, pr, base, s, fetch<XT>(g.x, base, s));
  }
}

template <typename XT, int METHOD>
__global__ void __launch_bounds__(THREADS, 2) qstem_kernel(const Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* Ws = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* sc_s = reinterpret_cast<float*>(smem + g.off_ss);
  float* sh_s = sc_s + COUT;
  auto* koff = reinterpret_cast<int2*>(smem + g.off_koff);
  auto* patch = reinterpret_cast<__nv_bfloat16*>(smem + g.off_patch);
  auto* Cs = reinterpret_cast<float*>(smem + g.off_cs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, qd = lane & 3;

  // once per block: W transposed to (Cout, K) rows, scale / shift, the koff
  // table (entry (ks, q): koff of k = 16 ks + 2q and k + 8), the patch's
  // padding columns, the first tile's patch
  for (int i = tid; i < g.ksteps * 16 * COUT; i += THREADS)
    Ws[(i & (COUT - 1)) * g.wp + (i >> 6)] = g.w[i];
  if (tid < COUT) {
    sc_s[tid] = g.scale[tid];
    sh_s[tid] = g.shift[tid];
  }
  for (int i = tid; i < g.ksteps * 4; i += THREADS) {
    int k[2] = {16 * (i >> 2) + 2 * (i & 3), 16 * (i >> 2) + 2 * (i & 3) + 8};
    int o[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dy = k[h] / g.runp;
      o[h] = k[h] < g.kd ? dy * g.pitch + k[h] - dy * g.runp : 0;
    }
    koff[i] = make_int2(o[0], o[1]);
  }
  for (int i = tid; i < g.ir * (g.pitch - g.iw); i += THREADS) {
    const int r = i / (g.pitch - g.iw);
    patch[r * g.pitch + g.iw + i - r * (g.pitch - g.iw)] = __float2bfloat16_rn(0.0f);
  }
  {
    int n, p0, q0;
    decode(g, blockIdx.x, n, p0, q0);
    stage_rest<XT>(g, patch, n, p0, q0, tid);
  }
  __syncthreads();

  const fq::InvQuant quant = fq::make_inv_quant(METHOD, fq::load_consts(g.aconsts, 1, 0));
  const uint32_t* patch32 = reinterpret_cast<const uint32_t*>(patch);
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    int n, p0, q0;
    decode(g, t, n, p0, q0);
    const int tn = t + gridDim.x;
    int nn = 0, np0 = 0, nq0 = 0;
    uint4 raw[MAXCH];
    if (tn < g.tiles) {                  // the next tile's patch, under the products
      decode(g, tn, nn, np0, nq0);
#pragma unroll
      for (int k = 0; k < MAXCH; ++k) {
        const int i = tid + k * THREADS;
        if (i < g.ir * g.nch) {
          const int pr = i / g.nch;
          const Span s = row_span(g, nn, np0, nq0, pr);
          raw[k] = fetch<XT>(g.x, chunk_base<XT>(s, i - pr * g.nch), s);
        }
      }
    }

    // products: warp w takes m16 tiles w, w + 8, ... of the conv pixels,
    // all 64 channels (8 n8 tiles)
    const int cr0 = 2 * p0 - 1, cc0 = 2 * q0 - 1;
    for (int mt = warp; mt < g.mtiles; mt += WARPS) {
      int pb[2], m[2];
      bool inside[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = mt * 16 + gr + 8 * h;
        pb[h] = 0;
        inside[h] = false;
        if (m[h] < g.mp) {
          const int r = m[h] / g.cc, c = m[h] - r * g.cc;
          pb[h] = 2 * r * g.pitch + 2 * c * g.cin;
          inside[h] = cr0 + r >= 0 && cr0 + r < g.C && cc0 + c >= 0 && cc0 + c < g.C;
        }
      }
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      for (int ks = 0; ks < g.ksteps; ++ks) {
        const int2 ko = koff[ks * 4 + qd];
        const uint32_t a[4] = {patch32[(pb[0] + ko.x) >> 1], patch32[(pb[1] + ko.x) >> 1],
                               patch32[(pb[0] + ko.y) >> 1], patch32[(pb[1] + ko.y) >> 1]};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t b[4];
          wm::ldsm_x4(b, Ws + (16 * p + ((lane >> 4) & 1) * 8 + (lane & 7)) * g.wp +
                             ks * 16 + ((lane >> 3) & 1) * 8);
          wm::mma_bf16(acc[2 * p], a, b[0], b[1]);
          wm::mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
        }
      }
      // folded BN + relu on the accumulators; conv pixels outside the
      // image are the pool's padding
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * qd;
        const float2 sc = *reinterpret_cast<const float2*>(sc_s + c);
        const float2 sh = *reinterpret_cast<const float2*>(sh_s + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (m[h] >= g.mp) continue;
          float2 y = make_float2(0.0f, 0.0f);
          if (inside[h]) {
            y.x = fq::apply_act(__fadd_rn(__fmul_rn(acc[j][2 * h], sc.x), sh.x), fq::kActRelu);
            y.y = fq::apply_act(__fadd_rn(__fmul_rn(acc[j][2 * h + 1], sc.y), sh.y),
                                fq::kActRelu);
          }
          *reinterpret_cast<float2*>(Cs + m[h] * CSP + c) = y;
        }
      }
    }
    __syncthreads();                     // products done with the patch; Cs complete

    if (tn < g.tiles) {
#pragma unroll
      for (int k = 0; k < MAXCH; ++k) {
        const int i = tid + k * THREADS;
        if (i < g.ir * g.nch) {
          const int pr = i / g.nch;
          const Span s = row_span(g, nn, np0, nq0, pr);
          put<XT>(g, patch, pr, chunk_base<XT>(s, i - pr * g.nch), s, raw[k]);
        }
      }
      stage_rest<XT>(g, patch, nn, np0, nq0, tid + MAXCH * THREADS);
    }

    // 3x3/2 max pool over the conv tile, then the output quant; a thread
    // takes 8 channels of a pooled pixel
    for (int i = tid; i < g.tp * g.tq * 8; i += THREADS) {
      const int oct = i & 7, pix = i >> 3, pp = pix / g.tq, qq = pix - pp * g.tq;
      const int p = p0 + pp, q = q0 + qq;
      if (p >= g.P || q >= g.P) continue;
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = 0.0f;     // every window holds a pixel >= 0
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const float4* src = reinterpret_cast<const float4*>(
              Cs + ((2 * pp + dr) * g.cc + 2 * qq + dc) * CSP + 8 * oct);
          const float4 u = src[0], v = src[1];
          y[0] = fmaxf(y[0], u.x); y[1] = fmaxf(y[1], u.y);
          y[2] = fmaxf(y[2], u.z); y[3] = fmaxf(y[3], u.w);
          y[4] = fmaxf(y[4], v.x); y[5] = fmaxf(y[5], v.y);
          y[6] = fmaxf(y[6], v.z); y[7] = fmaxf(y[7], v.w);
        }
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = fq::quantize_inv_m<METHOD>(y[e], quant, g.emit_norm);
      const long long o = ((static_cast<long long>(n) * g.P + p) * g.P + q) * COUT + 8 * oct;
      if (g.emit_norm) {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(g.out) + o) =
            make_uint4(wm::pack_bf16(y[0], y[1]), wm::pack_bf16(y[2], y[3]),
                       wm::pack_bf16(y[4], y[5]), wm::pack_bf16(y[6], y[7]));
      } else {
        auto* f = reinterpret_cast<float4*>(static_cast<float*>(g.out) + o);
        f[0] = make_float4(y[0], y[1], y[2], y[3]);
        f[1] = make_float4(y[4], y[5], y[6], y[7]);
      }
    }
    __syncthreads();                     // Cs consumed, the next patch written
  }
}

template <typename XT, int METHOD>
int launch(Geo g, int smem, cudaStream_t stream) {
  auto kernel = qstem_kernel<XT, METHOD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = g.tiles < per_sm * sms ? g.tiles : per_sm * sms;
  kernel<<<grid, THREADS, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int dispatch(const Geo& g, int smem, int method, cudaStream_t st) {
  switch (method) {
    case fq::kQuantNone: return launch<XT, fq::kQuantNone>(g, smem, st);
    case fq::kQuantFp8: return launch<XT, fq::kQuantFp8>(g, smem, st);
    case fq::kQuantIntAsym: return launch<XT, fq::kQuantIntAsym>(g, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int align16(int b) { return (b + 15) / 16 * 16; }

}  // namespace

// x (N, S, S, cin) float32 or bf16 (x_bf16), 16-byte aligned; w (Kp, 64)
// bf16 in the dy-major K order of ops/kernels/qstem.py:weight_matrix (row
// dy * runp + dx * cin + ci, runp = 7 * cin rounded up to even, zero rows
// to Kp = 7 * runp rounded up to 16); out (N, P, P, 64) bf16 (emit_norm) or
// float32.  Only Cout = 64 (the ResNet stem).  tp x tq: the pooled tile
// (ops/kernels/qstem.py:stem_tile).
extern "C" int qstem_launch(const void* x, int x_bf16, const void* w, int Kp,
                            const float* aconsts, const float* scale,
                            const float* shift, void* out, int N, int S,
                            int cin, int a_method, int emit_norm, int tp,
                            int tq, void* stream) {
  Geo g;
  g.x = x; g.w = static_cast<const __nv_bfloat16*>(w); g.aconsts = aconsts;
  g.scale = scale; g.shift = shift; g.out = out;
  g.S = S; g.cin = cin;
  g.C = (S - 1) / 2 + 1;
  g.P = (g.C - 1) / 2 + 1;
  g.tp = tp; g.tq = tq;
  g.cr = 2 * g.tp + 1; g.cc = 2 * g.tq + 1;
  g.mp = g.cr * g.cc; g.mtiles = (g.mp + 15) / 16;
  g.ir = 2 * g.cr + 5;
  g.iw = (2 * g.cc + 5) * cin;
  g.pitch = (g.iw + 2) / 2 * 2;          // even, one element past the row
  const int epc = x_bf16 ? 8 : 4;
  g.nch = (g.iw + epc - 1) / epc + 1;
  g.runp = (7 * cin + 1) / 2 * 2;
  g.kd = 7 * g.runp;
  g.ksteps = (g.kd + 15) / 16;
  g.wp = 16 * g.ksteps + 8;
  g.tiles_x = (g.P + g.tq - 1) / g.tq;
  g.tiles_y = (g.P + g.tp - 1) / g.tp;
  g.tiles = N * g.tiles_x * g.tiles_y;
  g.emit_norm = emit_norm != 0;
  if (Kp != 16 * g.ksteps || cin < 1 || g.tp < 1 || g.tq < 1 || N < 1 ||
      (emit_norm && a_method == fq::kQuantNone))
    return static_cast<int>(cudaErrorInvalidValue);
  g.off_ss = align16(COUT * g.wp * 2);
  g.off_koff = g.off_ss + 2 * COUT * 4;
  g.off_patch = align16(g.off_koff + g.ksteps * 4 * 8);
  g.off_cs = align16(g.off_patch + g.ir * g.pitch * 2);
  const int smem = g.off_cs + g.mp * CSP * 4;
  auto st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? dispatch<__nv_bfloat16>(g, smem, a_method, st)
                : dispatch<float>(g, smem, a_method, st);
}

// Int8 quant-matmul for Hopper: y = epilogue(xs @ wsg^T + corrections).
//
// Replaces _qmatmul_int8_kernel of fp8_quantization_tpu/ops/pallas/
// qmatmul.py (line 212, pallas_call at line 389).  x is (M, K) float32,
// quantized to s8 on the asymmetric grid while its tile is staged, or
// (M, K) int8 already on that grid (the s8 input branch: the ViT's
// producers emit its operand, nn/factored.PrequantS8, and the rows are
// staged as they are, K % 4 == 0 so that a row's four bytes load as one
// word); w is
// (N, K) row-major, either the baked int8 grid (w_prequant) or float32
// quantized per output channel while staged.  The s8 x s8 products run on
// the integer tensor cores (int32 sums) and rowsum(xs) and colsum(wsg) are
// summed beside them; the corrections and the float epilogue are in
// int8_epilogue.cuh.  Ragged M, N and K are masked in the kernel and the K
// term uses the true K: the host makes no padded copies (the Pallas
// wrapper pads K and relies on the padding cancelling).
//
// Bound on the card: at ResNet-18's shapes (the 1x1/2 downsamples at
// K = 64..256 and the fc at M = batch) it reads float32 activations and
// writes float32 outputs, about 69 MB a forward at batch 64 (0.021 ms at
// 3.35 TB/s) for 2.5 GOP (0.0013 ms at 1,979 TOP/s): bytes bound it.  What
// the design does about them: each block owns a BM x BN tile, BM = 32 or
// 64 rows and BN = 64, 128 or 256 columns chosen per shape by the wrapper
// (ops/kernels/qmatmul_int8.py:int8_tile), so that x is read and quantized
// once per tile at N <= 256 and twice at N = 512, and each output is
// written once, from the accumulators' registers.  K runs in chunks of 32
// through two shared-memory buffers: the next chunk's x is loaded into
// registers and the baked weights copied by 16-byte cp.async before the
// current chunk's products (ldmatrix + mma.sync.m16n8k32 s8); weights of
// up to 32 KB go through L1 (.ca), since every block of an SM reads them
// again.  The loaded x is quantized (i8::quant_x, the plain version's IEEE
// division) into the other buffer while they run; one barrier a chunk.
// Where M x N leaves fewer than 128 blocks (the fc: M = 64, N = 1000), K
// is split over a cluster of up to 8 blocks: each sums its own chunks, the
// int32 partial products, row and column sums are added through
// distributed shared memory (integers, so in any order the same total),
// and each rank runs the float epilogue once for its share of the tile's
// rows.  What still holds it back (ops/kernels/variants.py qmatmul_int8,
// PERF.md section 6): each block runs its few chunks as one chain of
// loads, quantization, products and epilogue, and removing any one phase
// saves 10-20%; two blocks an SM overlap too little of it.
// The s8 input branch reads a quarter of x's bytes and skips the
// quantizer: at the ViT's qkv, proj and mlp2 (batch 64, 197 tokens) the
// three launches of a block move 126 MB, 0.038 ms at an H100 SXM's 3.35
// TB/s, for 29.8 GOP, 0.015 ms at its 1,979 TOP/s (data-sheet rates, at
// the 700 W limit): still bound by bytes, now mostly the float32 outputs.
// One kernel per tile shape, weight type and input type: 24 kernels.
#include <cooperative_groups.h>

#include <type_traits>

#include "int8_epilogue.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256, BK = 32, PLANES = BK / 16;

struct Args {
  const void* x;
  const void* w;
  const float* w_delta;
  const float* w_scalars;
  const float* a_scalars;
  const float* scale;
  const float* shift;
  float* out;
  int M, N, K, a_bits, w_bits, activation, splits;
  bool x_vec;     // float32 x rows in 16-byte pieces (K % 4 == 0)
  bool w_vec;     // w rows in 16-byte pieces (int8: K % 16, float: K % 4)
  bool w_l1;      // baked weights small enough to copy through L1
};

// 16 weights of row n from k on the s8 grid: copied (int8) or quantized
// (float32, i8::quant_w); zeros past N and K.
__device__ __forceinline__ uint4 w_piece(const int8_t* w, const Args& a, int n,
                                         int k, const i8::Params&) {
  uint32_t word[4] = {0, 0, 0, 0};
  if (n < a.N) {
    const int8_t* src = w + static_cast<long long>(n) * a.K + k;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (k + e < a.K)
        word[e >> 2] |= (static_cast<uint32_t>(src[e]) & 0xFF) << (8 * (e & 3));
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

__device__ __forceinline__ uint4 w_piece(const float* w, const Args& a, int n,
                                         int k, const i8::Params& p) {
  int v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = 0;
  if (n < a.N) {
    const float dw = fmaxf(a.w_delta[n], 1e-8f);
    const float* src = w + static_cast<long long>(n) * a.K + k;
    if (a.w_vec && k + 16 <= a.K) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src + 4 * q));
        v[4 * q] = i8::quant_w(f.x, dw, p);
        v[4 * q + 1] = i8::quant_w(f.y, dw, p);
        v[4 * q + 2] = i8::quant_w(f.z, dw, p);
        v[4 * q + 3] = i8::quant_w(f.w, dw, p);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (k + e < a.K) v[e] = i8::quant_w(src[e], dw, p);
    }
  }
  return make_uint4(i8::pack4(v[0], v[1], v[2], v[3]),
                    i8::pack4(v[4], v[5], v[6], v[7]),
                    i8::pack4(v[8], v[9], v[10], v[11]),
                    i8::pack4(v[12], v[13], v[14], v[15]));
}

// BM x BN tile, 8 warps as WM x WN, each warp 32 rows (two m16 tiles) by
// BN / WN columns (NB n8 tiles).  SPLIT: the block is one rank of a
// cluster over K (grid z).  XT: float (x quantized here) or int8_t (x on
// the s8 grid already).
template <int BM, int BN, bool SPLIT, typename WT, typename XT>
__global__ void __launch_bounds__(THREADS, 2)
qmatmul_int8_kernel(const Args a) {
  constexpr int WM = BM / 32, WN = 8 / WM, WNC = BN / WN, NB = WNC / 8;
  constexpr int XF4 = BM * BK / 4 / THREADS;     // float4s of x a thread
  constexpr int XROW = BK / 4;                   // float4s of an x row
  constexpr bool COPY_W = sizeof(WT) == 1;
  constexpr bool X8 = sizeof(XT) == 1;
  static_assert(NB % 2 == 0 && XF4 >= 1, "tile shape");
  __shared__ __align__(128) int8_t xs[2][PLANES * BM * 16];   // [plane][row][16]
  __shared__ __align__(128) int8_t ws[2][PLANES * BN * 16];
  __shared__ int s_rowsum[BM], s_colsum[BN];
  __shared__ __align__(16) int part[SPLIT ? BM * BN : 1];
  __shared__ int sums[SPLIT ? BM + BN : 1];   // a rank's rows', all columns'

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % WM, warp_n = warp / WM;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = a.M, N = a.N, K = a.K;
  const i8::Params p = i8::load_params(a.a_scalars, a.w_scalars, a.a_bits, a.w_bits);
  const XT* x = static_cast<const XT*>(a.x);
  const WT* w = static_cast<const WT*>(a.w);
  const int nch = (K + BK - 1) / BK;
  const int c_lo = SPLIT ? static_cast<int>(blockIdx.z) * nch / a.splits : 0;
  const int c_hi = SPLIT ? (static_cast<int>(blockIdx.z) + 1) * nch / a.splits : nch;
  if (tid < BN) s_colsum[tid] = 0;

  // x: this thread's float4 f = tid + THREADS * i of a chunk (an s8 x:
  // the word of the same four values) is row f / XROW, k 4 * (f % XROW);
  // its quantized bytes go to plane (f % XROW) / 4.
  std::conditional_t<X8, uint32_t, float4> xr[XF4];
  int rs[XF4];
#pragma unroll
  for (int i = 0; i < XF4; ++i) rs[i] = 0;
  auto load_x = [&](int c) {
#pragma unroll
    for (int i = 0; i < XF4; ++i) {
      const int f = tid + THREADS * i, m = m0 + f / XROW, k = c * BK + (f % XROW) * 4;
      const XT* src = x + static_cast<long long>(m) * K + k;
      if constexpr (X8) {
        // K % 4 == 0: a word is all inside the row or all past it
        xr[i] = m < M && k < K ? __ldg(reinterpret_cast<const unsigned int*>(src)) : 0u;
      } else if (m < M && a.x_vec && k + 4 <= K) {
        xr[i] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        const bool r = m < M;
        xr[i] = make_float4(r && k < K ? src[0] : 0.0f, r && k + 1 < K ? src[1] : 0.0f,
                            r && k + 2 < K ? src[2] : 0.0f, r && k + 3 < K ? src[3] : 0.0f);
      }
    }
  };
  auto quantize_x = [&](int c, int buf) {
#pragma unroll
    for (int i = 0; i < XF4; ++i) {
      const int f = tid + THREADS * i, row = f / XROW, m = m0 + row;
      const int k = c * BK + (f % XROW) * 4;
      uint32_t q;
      if constexpr (X8) {     // staged as loaded (zeros past M and K)
        q = xr[i];
        rs[i] = __dp4a(static_cast<int>(q), 0x01010101, rs[i]);
      } else {
        const bool r = m < M;
        const int v0 = r && k < K ? i8::quant_x(xr[i].x, p) : 0;
        const int v1 = r && k + 1 < K ? i8::quant_x(xr[i].y, p) : 0;
        const int v2 = r && k + 2 < K ? i8::quant_x(xr[i].z, p) : 0;
        const int v3 = r && k + 3 < K ? i8::quant_x(xr[i].w, p) : 0;
        rs[i] += v0 + v1 + v2 + v3;
        q = i8::pack4(v0, v1, v2, v3);
      }
      *reinterpret_cast<uint32_t*>(&xs[buf][(f % XROW >> 2) * BM * 16 + row * 16 +
                                             (f & 3) * 4]) = q;
    }
  };
  // w: 16-byte unit u = (plane u / BN, column u % BN) of a chunk
  auto stage_w = [&](int c, int buf) {
    for (int u = tid; u < PLANES * BN; u += THREADS) {
      const int n = n0 + u % BN, k = c * BK + (u / BN) * 16;
      if (COPY_W && a.w_vec) {
        const bool ok = n < N && k < K;
        const void* src = ok ? static_cast<const void*>(
                                   reinterpret_cast<const int8_t*>(w) +
                                   static_cast<long long>(n) * K + k)
                             : a.w;
        if (a.w_l1)
          i8::cp_async16_ca(i8::saddr(&ws[buf][u * 16]), src, ok);
        else
          i8::cp_async16(i8::saddr(&ws[buf][u * 16]), src, ok);
      } else {
        *reinterpret_cast<uint4*>(&ws[buf][u * 16]) = w_piece(w, a, n, k, p);
      }
    }
  };
  const bool async_w = COPY_W && a.w_vec;

  int acc[2][NB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  int cs = 0;   // colsum share: column tid % BN over units tid + THREADS j

  const uint32_t a_lane = ((lane >> 4) * BM + warp_m * 32 + (lane & 15)) * 16;
  const uint32_t b_lane =
      (((lane >> 3) & 1) * BN + warp_n * WNC + (lane & 7) + ((lane >> 4) << 3)) * 16;

  if (c_lo < c_hi) {
    load_x(c_lo);
    stage_w(c_lo, 0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    quantize_x(c_lo, 0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  for (int c = c_lo; c < c_hi; ++c) {
    const int buf = (c - c_lo) & 1;
    const bool next = c + 1 < c_hi;
    if (next) {             // chunk c + 1's loads, issued before c's products
      load_x(c + 1);
      if (async_w) stage_w(c + 1, buf ^ 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int u = tid; u < PLANES * BN; u += THREADS) {
      const uint4 q = *reinterpret_cast<const uint4*>(&ws[buf][u * 16]);
      cs = __dp4a(static_cast<int>(q.x), 0x01010101, cs);
      cs = __dp4a(static_cast<int>(q.y), 0x01010101, cs);
      cs = __dp4a(static_cast<int>(q.z), 0x01010101, cs);
      cs = __dp4a(static_cast<int>(q.w), 0x01010101, cs);
    }
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {     // planes 2 ks, 2 ks + 1
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        i8::ldmatrix_x4(af[i], i8::saddr(xs[buf]) + a_lane + (2 * ks * BM + i * 16) * 16);
#pragma unroll
      for (int jp = 0; jp < NB / 2; ++jp) {
        uint32_t b[4];
        i8::ldmatrix_x4(b, i8::saddr(ws[buf]) + b_lane + (2 * ks * BN + jp * 16) * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          i8::mma_s8(acc[i][2 * jp], af[i], b[0], b[1]);
          i8::mma_s8(acc[i][2 * jp + 1], af[i], b[2], b[3]);
        }
      }
    }
    if (next) {             // under the products
      if (!async_w) stage_w(c + 1, buf ^ 1);
      quantize_x(c + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();        // chunk c + 1 in place; buffer buf free
  }

  // Row sums: the XROW lanes of a row; column sums: the threads of a
  // column.
#pragma unroll
  for (int i = 0; i < XF4; ++i) {
    int s = rs[i];
#pragma unroll
    for (int o = 1; o < XROW; o *= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane % XROW == 0) s_rowsum[(tid + THREADS * i) / XROW] = s;
  }
  if (tid < PLANES * BN) atomicAdd(&s_colsum[tid % BN], cs);

  if constexpr (SPLIT) {
    // Partials into shared memory, added across the cluster by the rank
    // that owns their rows.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = warp_m * 32 + i * 16 + (lane >> 2) + 8 * h;
          const int cl = warp_n * WNC + j * 8 + 2 * (lane & 3);
          *reinterpret_cast<int2*>(&part[rl * BN + cl]) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                // every rank's partials are in place
    const int ranks = a.splits, rank = static_cast<int>(cluster.block_rank());
    const int r0 = rank * BM / ranks, rows = (rank + 1) * BM / ranks - r0;
    // this rank's rows' sums and the tile's column sums, once
    for (int i = tid; i < rows + BN; i += THREADS) {
      const int* src = i < rows ? &s_rowsum[r0 + i] : &s_colsum[i - rows];
      int t = 0;
      for (int k = 0; k < ranks; ++k) t += *cluster.map_shared_rank(src, k);
      sums[i] = t;
    }
    __syncthreads();
    for (int idx = tid; idx < rows * (BN / 4); idx += THREADS) {
      const int rl = r0 + idx / (BN / 4), cl = (idx % (BN / 4)) * 4, m = m0 + rl;
      if (m >= M) continue;
      int t[4] = {0, 0, 0, 0};
      for (int k = 0; k < ranks; ++k) {
        const int4 v = *reinterpret_cast<const int4*>(
            cluster.map_shared_rank(part, k) + rl * BN + cl);
        t[0] += v.x; t[1] += v.y; t[2] += v.z; t[3] += v.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + cl + e;
        if (n < N)
          a.out[static_cast<long long>(m) * N + n] = i8::epilogue(
              t[e], sums[rl - r0], sums[rows + cl + e], K, p,
              fmaxf(a.w_delta[n], 1e-8f), a.scale[n], a.shift[n], a.activation);
      }
    }
    cluster.sync();                // no rank leaves while read
  } else {
    __syncthreads();
    // Epilogue from the accumulators, column pairs as float2 stores.
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int cl = warp_n * WNC + j * 8 + 2 * (lane & 3), n = n0 + cl;
      if (n >= N) continue;
      const bool two = n + 1 < N;
      float dw[2], sc[2], sh[2];
      int col[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ce = two ? e : 0;
        dw[e] = fmaxf(a.w_delta[n + ce], 1e-8f);
        sc[e] = a.scale[n + ce];
        sh[e] = a.shift[n + ce];
        col[e] = s_colsum[cl + ce];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = warp_m * 32 + i * 16 + (lane >> 2) + 8 * h, m = m0 + rl;
          if (m >= M) continue;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            y[e] = i8::epilogue(acc[i][j][2 * h + e], s_rowsum[rl], col[e], K, p,
                                dw[e], sc[e], sh[e], a.activation);
          float* o = a.out + static_cast<long long>(m) * N + n;
          if (two && pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
          } else {
            o[0] = y[0];
            if (two) o[1] = y[1];
          }
        }
    }
  }
}

template <int BM, int BN, bool SPLIT, typename WT, typename XT>
int launch(const Args& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>((a.M + BM - 1) / BM),
                     static_cast<unsigned>((a.N + BN - 1) / BN),
                     static_cast<unsigned>(a.splits));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = static_cast<unsigned>(a.splits);
  cfg.attrs = &attr;
  cfg.numAttrs = SPLIT ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, qmatmul_int8_kernel<BM, BN, SPLIT, WT, XT>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT, typename XT>
int dispatch(const Args& a, int bm, int bn, cudaStream_t st) {
  if (a.splits > 1)
    return bm == 64 && bn == 64 ? launch<64, 64, true, WT, XT>(a, st)
                                : static_cast<int>(cudaErrorInvalidValue);
  if (bm == 64 && bn == 64) return launch<64, 64, false, WT, XT>(a, st);
  if (bm == 64 && bn == 128) return launch<64, 128, false, WT, XT>(a, st);
  if (bm == 64 && bn == 256) return launch<64, 256, false, WT, XT>(a, st);
  if (bm == 32 && bn == 128) return launch<32, 128, false, WT, XT>(a, st);
  if (bm == 32 && bn == 256) return launch<32, 256, false, WT, XT>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bm, bn, splits: the tile and the K split (ops/kernels/qmatmul_int8.py:
// int8_tile): (64, 64), (64, 128), (64, 256), (32, 128) or (32, 256);
// splits 1, or 2..8 (cluster ranks over K) with (64, 64).  x (and a baked
// int8 w) 16-byte aligned; an int8 x (x_int8) needs K % 4 == 0.
extern "C" int qmatmul_int8_launch(const void* x, const void* w, int w_int8,
                                   int x_int8, const float* w_delta,
                                   const float* w_scalars,
                                   const float* a_scalars, const float* scale,
                                   const float* shift, float* out, int M,
                                   int N, int K, int a_bits, int w_bits,
                                   int activation, int bm, int bn, int splits,
                                   void* stream) {
  if (splits < 1 || splits > 8 || splits > (K + BK - 1) / BK ||
      (x_int8 && K % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, w, w_delta, w_scalars, a_scalars, scale, shift, out, M, N, K,
         a_bits, w_bits, activation, splits, K % 4 == 0,
         reinterpret_cast<uintptr_t>(w) % 16 == 0 && K % (w_int8 ? 16 : 4) == 0,
         static_cast<long long>(N) * K <= 32 * 1024};
  auto st = static_cast<cudaStream_t>(stream);
  if (x_int8)
    return w_int8 ? dispatch<int8_t, int8_t>(a, bm, bn, st)
                  : dispatch<float, int8_t>(a, bm, bn, st);
  return w_int8 ? dispatch<int8_t, float>(a, bm, bn, st)
                : dispatch<float, float>(a, bm, bn, st);
}

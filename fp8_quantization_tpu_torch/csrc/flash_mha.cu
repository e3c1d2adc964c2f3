// Flash attention for Hopper: out = softmax(q k^T * sm_scale) v per
// (batch, head), for the quantized ViT's attention.
//
// Replaces flash_mha of fp8_quantization_tpu/ops/pallas/attention.py (line
// 43), which wraps jax.experimental's Pallas TPU flash-attention kernel
// (_flash_attention_kernel_single_batch and its single-step variant).  The
// arithmetic is that kernel's, step by step: q, k and v rounded to bf16;
// s = dot_f32(q, k) * sm_scale; keys in blocks of 128, the padding keys of
// the last block masked (they add exactly 0, as the Pallas mask value does
// for a real query); with one block p = exp(s - m) / sum before the bf16
// rounding, with more an online softmax whose unnormalized p is rounded to
// bf16 and whose accumulator is updated as acc *= l_corr * (1 / l_next),
// acc += dot(p, v) * (1 / l_next).  The output is rounded to bf16 and
// stored as float32.  expf, not __expf, and the build's -fmad=false keep
// every step a single rounding, as in the plain PyTorch version.
//
// Layout: q, k, v are read through (batch, head, row) strides with D = 64
// contiguous, as float32 or bf16, so the model passes views of its
// (B, S, 3, H, D) qkv output; the output is written (B, S, H, D), the
// projection's (B*S, H*D) input.  Every row and base must be 16-byte
// aligned (the wrapper checks it).
//
// Bound on the card: at ViT-S/16 (B = 64, H = 6, S = 197, D = 64) one call
// reads 58 MB of float32 q/k/v and writes 19 MB (23 us at 3.35 TB/s) and
// does 3.8 GFLOP of tensor-core work (3.9 us at 989 TFLOP/s): bytes bound
// it, with a 6x margin over the products.  So the design spends nothing on
// wgmma and everything on moving each byte once, in wide transactions:
//
//   * a work item is one (b, h, query group) with one warp per 16 query
//     rows and up to 13 warps (208 rows), so every query row of ViT-S/16's
//     197 is in one item and each K/V byte of a (b, h) leaves device memory
//     once;
//   * q and the K and V of each 128-key step arrive by 16-byte cp.async
//     into raw (input-type) buffers, zero-filled past S; one pass converts
//     them to bf16 rows that ldmatrix reads;
//   * one persistent block an SM walks the items, and the copies of the
//     next step, or in the last step those of the next item's q and first
//     step, run under the current step's products, so the block never
//     waits on device memory between items;
//   * each warp keeps its 16 x 128 scores in m16n8 accumulator fragments,
//     reduces the row max and sum within the quad (two shuffles each),
//     packs p to bf16 A fragments in registers (the C layout of two n8
//     tiles is the A layout of a k16 step) for the p.v product, and keeps
//     the step's p.v sum and the running accumulator in registers: no
//     score or probability scratch in shared memory.
//
// Occupancy: a thread holds 64 score, 32 accumulator and 32 p.v registers
// at most, so a 13-warp block takes all of an SM's registers (ptxas gives
// it 128 a thread): one block of 13 warps an SM, against two blocks of 4
// warps before; its 185 KB of shared memory (float32 input) would allow
// one block too.  The overlap of copies and products, not more warps,
// hides the load latency.
#include <math.h>

#include <algorithm>
#include <type_traits>

#include "warp_mma.cuh"

namespace {

constexpr int D = 64;          // head width (ViT-S/16, ViT-B, ViT-L)
constexpr int BKV = 128;       // keys per step, the Pallas block_k
constexpr int MAX_WARPS = 13;  // query rows per block: 16 per warp
constexpr int LD = D + 8;      // bf16 smem row (144 B: ldmatrix without
                               // bank conflicts)

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs;
};

template <typename T>
struct Stage {
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int SEGS = D / VEC;         // 16-byte pieces per row
  static constexpr size_t raw_kv = sizeof(T) * 2 * BKV * D;   // K, V raw
  static size_t bytes(int nw) {                // + q raw, K, V and q bf16
    return raw_kv + sizeof(T) * 16 * nw * D +
           sizeof(__nv_bfloat16) * (2 * BKV + 16 * nw) * LD;
  }
};

// 16 bytes of input (four float32 or eight bf16 values) -> bf16 in shared
// memory.
__device__ __forceinline__ void to_bf16(__nv_bfloat16* dst, const float4& f) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(wm::pack_bf16(f.x, f.y), wm::pack_bf16(f.z, f.w));
}
__device__ __forceinline__ void to_bf16(__nv_bfloat16* dst, const uint4& b) {
  *reinterpret_cast<uint4*>(dst) = b;
}
template <typename T>
using Vec = typename std::conditional<sizeof(T) == 4, float4, uint4>::type;

// Rows r0 .. r0+n-1 of one (b, h) slice into a raw buffer (D contiguous),
// zero past S, by 16-byte cp.async.
template <typename T>
__device__ __forceinline__ void stage_rows(T* raw, const T* src, long long rs,
                                           int r0, int n, int S, int nthreads) {
  using St = Stage<T>;
  for (int i = threadIdx.x; i < n * St::SEGS; i += nthreads) {
    const int r = i / St::SEGS, c = (i % St::SEGS) * St::VEC;
    const bool valid = r0 + r < S;
    wm::cp_async16(raw + r * D + c, src + (valid ? (r0 + r) * rs : 0) + c, valid);
  }
}

// raw rows -> bf16 rows of LD
template <typename T>
__device__ __forceinline__ void convert_rows(__nv_bfloat16* dst, const T* raw,
                                             int n, int nthreads) {
  using St = Stage<T>;
  for (int i = threadIdx.x; i < n * St::SEGS; i += nthreads) {
    const int r = i / St::SEGS, c = (i % St::SEGS) * St::VEC;
    to_bf16(dst + r * LD + c, *reinterpret_cast<const Vec<T>*>(raw + r * D + c));
  }
}

// One (b, h, query group) of the launch: its q, k, v slices and rows.
template <typename T>
struct Item {
  const T *q, *k, *v;
  int b, h, q0;
  __device__ Item(const T* q_, const T* k_, const T* v_, const Strides& st,
                  int item, int groups, int H, int nrows) {
    const int grp = item % groups, bh = item / groups;
    h = bh % H;
    b = bh / H;
    q0 = grp * nrows;
    q = q_ + b * st.qb + h * st.qh;
    k = k_ + b * st.kb + h * st.kh;
    v = v_ + b * st.vb + h * st.vh;
  }
};

// Persistent: each block walks the items blockIdx.x, + gridDim.x, ...; the
// copies of the next step (or of the next item's q and first step) run
// under the current step's products.
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
flash_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, Strides st, float* __restrict__ out,
                 int H, int S, int groups, int items, float sm_scale) {
  using St = Stage<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* raw_kv = reinterpret_cast<T*>(smem);
  T* raw_q = reinterpret_cast<T*>(smem + St::raw_kv);
  const int nthreads = blockDim.x, nrows = nthreads / 2;   // 16 per warp
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(
      smem + St::raw_kv + sizeof(T) * nrows * D);
  __nv_bfloat16* vs = ks + BKV * LD;
  __nv_bfloat16* qs = vs + BKV * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int wr = warp * 16;              // the warp's first row in qs
  const bool single = S <= BKV;          // the Pallas single-step variant
  const int steps = (S + BKV - 1) / BKV;

  if (blockIdx.x < items) {              // the first item's q and step
    const Item<T> it(q, k, v, st, blockIdx.x, groups, H, nrows);
    stage_rows<T>(raw_q, it.q, st.qs, it.q0, nrows, S, nthreads);
    stage_rows<T>(raw_kv, it.k, st.ks, 0, BKV, S, nthreads);
    stage_rows<T>(raw_kv + BKV * D, it.v, st.vs, 0, BKV, S, nthreads);
    wm::cp_async_commit();
  }
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item<T> it(q, k, v, st, item, groups, H, nrows);
    const bool active = it.q0 + wr < S;    // the warp has a real query row
    float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.0f, 0.0f};
    // the warp's 16 x 64 accumulator: n8 tile t, rows g / g + 8
    float acc[D / 8][4];
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;

    for (int step = 0; step < steps; ++step) {
      const int k0 = step * BKV;
      const bool full = k0 + BKV <= S;     // no key of the step is masked
      wm::cp_async_wait<0>();
      __syncthreads();                     // the raw buffers hold this step;
                                           // the last step is done with ks,
                                           // vs (and qs)
      if (step == 0) convert_rows<T>(qs, raw_q, nrows, nthreads);
      convert_rows<T>(ks, raw_kv, 2 * BKV, nthreads);     // V rows follow K
      __syncthreads();
      if (step + 1 < steps) {              // the next step under this one
        stage_rows<T>(raw_kv, it.k, st.ks, k0 + BKV, BKV, S, nthreads);
        stage_rows<T>(raw_kv + BKV * D, it.v, st.vs, k0 + BKV, BKV, S, nthreads);
        wm::cp_async_commit();
      } else if (item + gridDim.x < items) {   // or the next item's first
        const Item<T> nx(q, k, v, st, item + gridDim.x, groups, H, nrows);
        stage_rows<T>(raw_q, nx.q, st.qs, nx.q0, nrows, S, nthreads);
        stage_rows<T>(raw_kv, nx.k, st.ks, 0, BKV, S, nthreads);
        stage_rows<T>(raw_kv + BKV * D, nx.v, st.vs, 0, BKV, S, nthreads);
        wm::cp_async_commit();
      }
      if (!active) continue;

      // s = q k^T: 16 n8 tiles of the warp's 16 rows x 128 keys
      float s[BKV / 8][4];
#pragma unroll
      for (int t = 0; t < BKV / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t a[4];
        wm::ldsm_x4(a, qs + (wr + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < BKV / 16; ++np) {
          uint32_t bk[4];
          wm::ldsm_x4(bk, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                              kc * 16 + ((lane >> 3) & 1) * 8);
          wm::mma_bf16(s[2 * np], a, bk[0], bk[1]);
          wm::mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // row statistics within the quad; p = exp(s - m_next)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < BKV / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] = __fmul_rn(s[t][e], sm_scale);
          if (full || k0 + 8 * t + 2 * q4 + (e & 1) < S)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
        }
      float m_next[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_next[r] = fmaxf(m_row[r], mx[r]);
      }
#pragma unroll
      for (int t = 0; t < BKV / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (full || k0 + 8 * t + 2 * q4 + (e & 1) < S)
                              ? expf(__fsub_rn(s[t][e], m_next[e >> 1]))
                              : 0.0f;
          s[t][e] = p;
          sum[e >> 1] = __fadd_rn(sum[e >> 1], p);
        }
      float corr[2], inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 1));
        sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 2));
        const float l_corr = __fmul_rn(expf(__fsub_rn(m_row[r], m_next[r])), l_row[r]);
        const float l_next = __fadd_rn(sum[r], l_corr);
        inv[r] = l_next == 0.0f ? 1.0f : __fdiv_rn(1.0f, l_next);
        corr[r] = __fmul_rn(l_corr, inv[r]);
        m_row[r] = m_next[r];
        l_row[r] = l_next;
      }

      // p as bf16 A fragments (normalized first in the single-step variant)
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float* c = s[2 * kk + hf];
          if (single) {
            c[0] = __fdiv_rn(c[0], sum[0]);
            c[1] = __fdiv_rn(c[1], sum[0]);
            c[2] = __fdiv_rn(c[2], sum[1]);
            c[3] = __fdiv_rn(c[3], sum[1]);
          }
          pa[kk][2 * hf] = wm::pack_bf16(c[0], c[1]);
          pa[kk][2 * hf + 1] = wm::pack_bf16(c[2], c[3]);
        }

      // o = p v over the step's 128 keys
      float o[D / 8][4];
#pragma unroll
      for (int t = 0; t < D / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[t][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          wm::ldsm_x4_t(bv, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                dp * 16 + (lane >> 4) * 8);
          wm::mma_bf16(o[2 * dp], pa[kk], bv[0], bv[1]);
          wm::mma_bf16(o[2 * dp + 1], pa[kk], bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < D / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[t][e] = single ? o[t][e]
                             : __fadd_rn(__fmul_rn(acc[t][e], corr[e >> 1]),
                                         __fmul_rn(o[t][e], inv[e >> 1]));
    }

    if (!active) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = it.q0 + wr + g + 8 * r;
      if (row >= S) continue;
      float* dst =
          out + ((static_cast<long long>(it.b) * S + row) * H + it.h) * D + 2 * q4;
#pragma unroll
      for (int t = 0; t < D / 8; ++t)
        *reinterpret_cast<float2*>(dst + 8 * t) = make_float2(
            __bfloat162float(__float2bfloat16_rn(acc[t][2 * r])),
            __bfloat162float(__float2bfloat16_rn(acc[t][2 * r + 1])));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const Strides& st,
           float* out, int B, int H, int S, int groups, int warps,
           float sm_scale, cudaStream_t stream) {
  auto kernel = flash_mha_kernel<T>;
  const size_t smem = Stage<T>::bytes(warps);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = groups * H * B;      // one block an SM walks them
  kernel<<<std::min(items, sms), warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), st, out, H, S, groups, items, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// groups x warps: the query grid of ops/kernels/attention.flash_grid, each
// group of 16 * warps rows one block.
extern "C" int flash_mha_launch(const void* q, const void* k, const void* v,
                                int in_bf16, long long qb, long long qh,
                                long long qs, long long kb, long long kh,
                                long long ks, long long vb, long long vh,
                                long long vs, float* out, int B, int H, int S,
                                int Dh, int groups, int warps, float sm_scale,
                                void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs};
  auto s = static_cast<cudaStream_t>(stream);
  if (Dh != D || warps < 1 || warps > MAX_WARPS || groups * warps * 16 < S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_bf16)
    return launch<__nv_bfloat16>(q, k, v, st, out, B, H, S, groups, warps, sm_scale, s);
  return launch<float>(q, k, v, st, out, B, H, S, groups, warps, sm_scale, s);
}

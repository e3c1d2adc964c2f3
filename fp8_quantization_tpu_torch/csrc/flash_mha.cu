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
// Layout: q, k, v are read through (batch, head, row) strides with D
// contiguous, as float32 or bf16 (rounded to bf16 while staged), so the
// model passes views of its (B, S, 3, H, D) qkv output; the output is
// written (B, S, H, D), the projection's (B*S, H*D) input.
//
// Bound on the card: at ViT-S/16 (B = 64, H = 6, S = 197, D = 64) one call
// does 3.8 GFLOP of tensor-core work (3.9 us at 989 TFLOP/s) and reads
// 58 MB of float32 q/k/v and writes 19 MB (23 us at 3.35 TB/s): bytes bound
// it.  Design: one block per (b, h, 64-query tile), four warps of 16 query
// rows; the q tile stays in shared memory, each 128-key step stages K and V
// in bf16 (rows past S zero-filled), the warp's 16x128 scores go through
// bf16 wmma into shared memory, the row statistics run over a warp with
// shuffles, p is stored as bf16 for the second wmma product, and the
// accumulator stays in registers.  Simple first: K and V are re-read by each
// query tile and staged without cp.async/TMA; wgmma and pipelining are later
// work.
#include <math.h>

#include "fq_epilogue.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block: four warps of 16
constexpr int BKV = 128;        // keys per step, the Pallas block_k
constexpr int THREADS = 128;
constexpr int LDS = BKV + 4;    // fp32 score / product scratch row
constexpr int LDP = BKV + 8;    // bf16 probability row

template <int D>
struct Layout {
  static constexpr int LD = D + 8;                    // bf16 q / k / v row
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(__nv_bfloat16) * BQ * LD;
  static constexpr size_t v = k + sizeof(__nv_bfloat16) * BKV * LD;
  static constexpr size_t s = v + sizeof(__nv_bfloat16) * BKV * LD;
  static constexpr size_t p = s + sizeof(float) * BQ * LDS;
  static constexpr size_t stats = p + sizeof(__nv_bfloat16) * BQ * LDP;
  static constexpr size_t bytes = stats + sizeof(float) * 4 * BQ;
};

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// rows row0 .. row0+nrows-1 of one (b, h) slice into bf16 shared memory,
// zero past S
template <typename T, int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const T* src,
                                           long long row_stride, int row0,
                                           int nrows, int S) {
  for (int i = threadIdx.x; i < nrows * D; i += THREADS) {
    const int r = i / D, c = i % D, row = row0 + r;
    const float x = row < S ? fq::to_float(src[row * row_stride + c]) : 0.0f;
    dst[r * Layout<D>::LD + c] = __float2bfloat16_rn(x);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, Strides st, float* __restrict__ out,
                 int H, int S, float sm_scale) {
  using namespace nvcuda;
  using L = Layout<D>;
  constexpr int LD = L::LD, NC = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  float* sc = reinterpret_cast<float*>(smem + L::s);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
  float* m_s = reinterpret_cast<float*>(smem + L::stats);
  float* l_s = m_s + BQ;
  float* corr_s = l_s + BQ;
  float* inv_s = corr_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int wr = warp * 16;               // the warp's first row of the tile
  const bool single = S <= BKV;           // the Pallas single-step variant
  q += b * st.qb + h * st.qh;
  k += b * st.kb + h * st.kh;
  v += b * st.vb + h * st.vh;

  stage_rows<T, D>(qs, q, st.qs, q0, BQ, S);
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  // the warp's 16 x D accumulator: row r, column lane + 32 * i
  float acc[16][NC];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.0f;

  for (int k0 = 0; k0 < S; k0 += BKV) {
    __syncthreads();                      // the last step is done with k, v
    stage_rows<T, D>(ks, k, st.ks, k0, BKV, S);
    stage_rows<T, D>(vs, v, st.vs, k0, BKV, S);
    __syncthreads();

    {  // s = q k^T for the warp's 16 rows and the step's 128 keys
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[BKV / 16];
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(c[j], 0.0f);
#pragma unroll
      for (int kd = 0; kd < D; kd += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, qs + wr * LD + kd, LD);
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bt;
          wmma::load_matrix_sync(bt, ks + 16 * j * LD + kd, LD);
          wmma::mma_sync(c[j], a, bt, c[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j)
        wmma::store_matrix_sync(sc + wr * LDS + 16 * j, c[j], LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // row statistics and p (bf16), one row at a time over the warp
    for (int r = wr; r < wr + 16; ++r) {
      float pv[BKV / 32];
      float m_cur = -INFINITY;
#pragma unroll
      for (int i = 0; i < BKV / 32; ++i) {
        const int c = lane + 32 * i;
        pv[i] = __fmul_rn(sc[r * LDS + c], sm_scale);
        if (k0 + c < S) m_cur = fmaxf(m_cur, pv[i]);
      }
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, warp_max(m_cur));
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < BKV / 32; ++i) {
        pv[i] = k0 + lane + 32 * i < S ? expf(__fsub_rn(pv[i], m_next)) : 0.0f;
        sum = __fadd_rn(sum, pv[i]);
      }
      sum = warp_sum(sum);
      if (single) {
#pragma unroll
        for (int i = 0; i < BKV / 32; ++i)
          ps[r * LDP + lane + 32 * i] = __float2bfloat16_rn(__fdiv_rn(pv[i], sum));
      } else {
        const float l_corr = __fmul_rn(expf(__fsub_rn(m_prev, m_next)), l_s[r]);
        const float l_next = __fadd_rn(sum, l_corr);
        const float inv = l_next == 0.0f ? 1.0f : __fdiv_rn(1.0f, l_next);
#pragma unroll
        for (int i = 0; i < BKV / 32; ++i)
          ps[r * LDP + lane + 32 * i] = __float2bfloat16_rn(pv[i]);
        __syncwarp();                     // every lane has read m_s, l_s
        if (lane == 0) {
          m_s[r] = m_next;
          l_s[r] = l_next;
          corr_s[r] = __fmul_rn(l_corr, inv);
          inv_s[r] = inv;
        }
      }
    }
    __syncwarp();

    {  // o = p v into the warp's rows of the score scratch
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, ps + wr * LDP + kk, LDP);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bv;
          wmma::load_matrix_sync(bv, vs + kk * LD + 16 * j, LD);
          wmma::mma_sync(o[j], a, bv, o[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        wmma::store_matrix_sync(sc + wr * LDS + 16 * j, o[j], LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* orow = sc + (wr + r) * LDS;
      if (single) {
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = orow[lane + 32 * i];
      } else {
        const float corr = corr_s[wr + r], inv = inv_s[wr + r];
#pragma unroll
        for (int i = 0; i < NC; ++i)
          acc[r][i] = __fadd_rn(__fmul_rn(acc[r][i], corr),
                                __fmul_rn(orow[lane + 32 * i], inv));
      }
    }
    __syncwarp();                         // the scratch is read before reuse
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + wr + r;
    if (row >= S) continue;
    float* dst = out + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      dst[lane + 32 * i] = __bfloat162float(__float2bfloat16_rn(acc[r][i]));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const Strides& st,
           float* out, int B, int H, int S, float sm_scale,
           cudaStream_t stream) {
  auto kernel = flash_mha_kernel<T, D>;
  constexpr size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), st, out, H, S, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

constexpr int HEAD_DIM = 64;            // ViT-S/16 (and ViT-B, ViT-L)

}  // namespace

extern "C" int flash_mha_launch(const void* q, const void* k, const void* v,
                                int in_bf16, long long qb, long long qh,
                                long long qs, long long kb, long long kh,
                                long long ks, long long vb, long long vh,
                                long long vs, float* out, int B, int H, int S,
                                int D, float sm_scale, void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs};
  auto s = static_cast<cudaStream_t>(stream);
  if (D != HEAD_DIM) return static_cast<int>(cudaErrorInvalidValue);
  if (in_bf16)
    return launch<__nv_bfloat16, HEAD_DIM>(q, k, v, st, out, B, H, S, sm_scale, s);
  return launch<float, HEAD_DIM>(q, k, v, st, out, B, H, S, sm_scale, s);
}

// Fused ResNet stem for Hopper: conv7x7/2 pad 3 + folded BN + relu +
// maxpool3x3/2 pad 1 + output quant (FP8 or int_asym), in one pass.
//
// Replaces _qstem_kernel of fp8_quantization_tpu/ops/pallas/qstem.py
// (line 88, pallas_call at line 242).  The Pallas kernel walks bands of
// conv rows over whole images in VMEM, carrying one conv row across each
// band seam.  Blocks on the card run in no order, so nothing is carried:
// each block owns a TP x TQ tile of pooled outputs of one image and
// recomputes the (2*TP+1) x (2*TQ+1) conv pixels its pooling windows read
// (the conv-row and conv-column halo).  The input patch is read once into
// shared memory and cast to bf16 as it loads (the Pallas plane-building
// prologue and its HBM copy go away), cin = 3 is read directly, im2col runs
// from shared memory into a (pixels x K) bf16 matrix and the product runs
// on the tensor cores in fp32.  Conv pixels outside the image are set to 0
// after relu: the max identity for post-relu values, so the pool's zero
// padding is exact.  The pool comes before the quant: FP8 and integer
// quantization are monotone, so quant(pool(y)) == pool(quant(y)) and 4x
// fewer values are quantized.
//
// Bound on the card: at (64, 224, 224, 3) the conv is 15.1 GFLOP against
// 19 MB of input and 26 MB of bf16 output, so operations bound it; the
// halo recomputation costs (9*17)/(8*16) = 1.2x the conv work.
#include <mma.h>

#include "fq_epilogue.cuh"

namespace {

constexpr int TP = 4, TQ = 8;                  // pooled rows / cols per block
constexpr int CR = 2 * TP + 1, CC = 2 * TQ + 1;  // conv rows / cols per block
constexpr int MP = CR * CC;                    // 153 conv pixels
constexpr int MPAD = (MP + 15) / 16 * 16;      // 160
constexpr int IR = 2 * CR + 5, IC = 2 * CC + 5;  // input patch rows / cols
constexpr int COUT = 64, LDW = COUT + 8, LDCS = COUT + 4;
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MFRAGS = MPAD / 16;              // 10

__host__ __device__ constexpr int lda(int kp) { return kp + 8; }

__host__ __device__ constexpr size_t smem_bytes(int kp, int cin) {
  // [A (MPAD x lda) bf16, later reused as the fp32 conv tile] [W] [patch]
  return ((MPAD * lda(kp) * 2 > MPAD * LDCS * 4 ? MPAD * lda(kp) * 2
                                                 : MPAD * LDCS * 4) +
          127) / 128 * 128 +
         (static_cast<size_t>(kp) * LDW * 2 + 127) / 128 * 128 +
         static_cast<size_t>(IR) * IC * cin * 2;
}

template <typename XT>
__global__ void __launch_bounds__(THREADS)
qstem_kernel(const XT* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             const float* __restrict__ aconsts,
             const float* __restrict__ scale, const float* __restrict__ shift,
             void* __restrict__ out, int S, int cin, int Kp, int C, int P,
             int a_method, bool emit_norm) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldA = lda(Kp);
  const size_t a_bytes =
      ((MPAD * ldA * 2 > MPAD * LDCS * 4 ? MPAD * ldA * 2 : MPAD * LDCS * 4) +
       127) / 128 * 128;
  auto* As = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* Cs = reinterpret_cast<float*>(smem);
  auto* Ws = reinterpret_cast<__nv_bfloat16*>(smem + a_bytes);
  auto* Xs = reinterpret_cast<__nv_bfloat16*>(
      smem + a_bytes + (static_cast<size_t>(Kp) * LDW * 2 + 127) / 128 * 128);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int n = blockIdx.z, p0 = blockIdx.y * TP, q0 = blockIdx.x * TQ;
  const int cr0 = 2 * p0 - 1, cc0 = 2 * q0 - 1;   // first conv row / col
  const int ih0 = 2 * cr0 - 3, iw0 = 2 * cc0 - 3;  // first input row / col
  const int K = 49 * cin;

  // input patch, cast to bf16 on load; outside the image = conv padding 0
  const XT* xn = x + static_cast<long long>(n) * S * S * cin;
  for (int i = tid; i < IR * IC * cin; i += THREADS) {
    const int ci = i % cin, pc = (i / cin) % IC, pr = i / (cin * IC);
    const int ih = ih0 + pr, iw = iw0 + pc;
    float v = 0.0f;
    if (ih >= 0 && ih < S && iw >= 0 && iw < S)
      v = fq::to_float(xn[(static_cast<long long>(ih) * S + iw) * cin + ci]);
    Xs[i] = __float2bfloat16_rn(v);
  }
  // weights (Kp x 64) bf16, rows >= K already zero
  for (int i = tid; i < Kp * COUT / 8; i += THREADS) {
    const int r = i / (COUT / 8), c = (i % (COUT / 8)) * 8;
    *reinterpret_cast<uint4*>(Ws + r * LDW + c) =
        *reinterpret_cast<const uint4*>(w + r * COUT + c);
  }
  __syncthreads();
  // im2col from the patch: A[m][k], m = conv pixel, k = (dy*7 + dx)*cin + ci
  for (int i = tid; i < MPAD * Kp; i += THREADS) {
    const int m = i / Kp, k = i % Kp;
    __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
    if (m < MP && k < K) {
      const int rr = m / CC, cc = m % CC;
      const int tap = k / cin, ci = k % cin;
      const int dy = tap / 7, dx = tap % 7;
      v = Xs[((2 * rr + dy) * IC + 2 * cc + dx) * cin + ci];
    }
    As[m * ldA + k] = v;
  }
  __syncthreads();

  // warp w owns m-fragments w and w + 8, all four 16-wide n-fragments
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int k = 0; k < Kp; k += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::load_matrix_sync(b[j], Ws + k * LDW + 16 * j, LDW);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mf = warp + WARPS * i;
      if (mf < MFRAGS) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, As + mf * 16 * ldA + k, ldA);
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
  }
  __syncthreads();   // every warp is done reading A before Cs overwrites it
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mf = warp + WARPS * i;
    if (mf < MFRAGS)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Cs + mf * 16 * LDCS + 16 * j, acc[i][j], LDCS,
                                wmma::mem_row_major);
  }
  __syncthreads();

  // folded BN + relu; conv pixels outside the conv output are pool padding
  for (int i = tid; i < MP * COUT; i += THREADS) {
    const int m = i / COUT, c = i % COUT;
    const int cr = cr0 + m / CC, cc = cc0 + m % CC;
    float y = 0.0f;
    if (cr >= 0 && cr < C && cc >= 0 && cc < C)
      y = fq::apply_act(__fadd_rn(__fmul_rn(Cs[m * LDCS + c], scale[c]),
                                  shift[c]),
                        fq::kActRelu);
    Cs[m * LDCS + c] = y;
  }
  __syncthreads();

  const fq::QuantConsts ac = fq::load_consts(aconsts, 1, 0);
  for (int i = tid; i < TP * TQ * COUT; i += THREADS) {
    const int c = i % COUT, qq = (i / COUT) % TQ, pp = i / (COUT * TQ);
    const int p = p0 + pp, q = q0 + qq;
    if (p >= P || q >= P) continue;
    float y = 0.0f;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        y = fmaxf(y, Cs[((2 * pp + dr) * CC + 2 * qq + dc) * LDCS + c]);
    y = fq::quantize(y, a_method, ac, emit_norm);
    fq::store_out(out, ((static_cast<long long>(n) * P + p) * P + q) * COUT + c,
                  y, emit_norm);
  }
}

template <typename XT>
int launch(const void* x, const void* w, int Kp, const float* aconsts,
           const float* scale, const float* shift, void* out, int N, int S,
           int cin, int a_method, int emit_norm, cudaStream_t stream) {
  const int C = (S - 1) / 2 + 1, P = (C - 1) / 2 + 1;
  const size_t smem = smem_bytes(Kp, cin);
  cudaError_t err = cudaFuncSetAttribute(
      qstem_kernel<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + TQ - 1) / TQ, (P + TP - 1) / TP, N);
  qstem_kernel<XT><<<grid, THREADS, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const __nv_bfloat16*>(w), aconsts,
      scale, shift, out, S, cin, Kp, C, P, a_method, emit_norm != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w: (Kp, 64) bf16, rows (dy*7 + dx)*cin + ci, zero from 49*cin to Kp
// (a multiple of 16); out: (N, P, P, 64).  Only Cout = 64 (the ResNet stem).
extern "C" int qstem_launch(const void* x, int x_bf16, const void* w, int Kp,
                            const float* aconsts, const float* scale,
                            const float* shift, void* out, int N, int S,
                            int cin, int a_method, int emit_norm,
                            void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, w, Kp, aconsts, scale, shift, out, N, S,
                                 cin, a_method, emit_norm, st);
  return launch<float>(x, w, Kp, aconsts, scale, shift, out, N, S, cin,
                       a_method, emit_norm, st);
}

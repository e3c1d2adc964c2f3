// Fused 3x3 SAME conv for Hopper: implicit GEMM + epilogue + output quant.
//
// Replaces _qconv3x3_kernel and _conv_epilogue of
// fp8_quantization_tpu/ops/pallas/qconv.py (lines 130 and 111, pallas_call
// at line 472).  The Pallas kernel holds whole images in VMEM; an SM's
// shared memory cannot, so this kernel is an implicit GEMM over NHWC with
// M = N*Ho*Wo output pixels, K = 9*Cin and N = Cout: column k is tap
// (dy, dx) = divmod(k / Cin, 3) and channel k % Cin, SAME padding is a
// zero fill and stride 2 is index arithmetic (the Pallas even/odd phase
// split was a Mosaic workaround and is gone).  The epilogue is y*scale +
// shift [+ residual], relu/relu6 and the output quant (FP8 or int_asym),
// stored as the normalized bf16 value (emit_norm) or float32.
//
// Bound on the card: about 215 GFLOP of bf16 products per ResNet-18
// forward at batch 64, 0.22 ms at 989 TFLOP/s, against about 0.42 GB of
// input, weights and output (0.13 ms at 3.35 TB/s): operations bound the
// forward, and at 56x56x64 the two bounds are about equal.  What the design does
// about it (csrc/gemm_sm90.cuh): the products run on wgmma.mma_async
// m64nBNk16 in two consumer warpgroups over a 128 x BN x 64 block tile,
// fed by a ring of 3 shared-memory stages in the 128-byte swizzle.  A is
// gathered from x by the implicit-im2col producer (sm90::ConvOperand: one
// 16-byte cp.async per 8 channels of a tap, zero-filled outside the image),
// B is the baked (Cout, 9*Cin) bf16 weight matrix, K-major as wgmma reads
// it, copied by cp.async; chunk kt + 2 is in flight while chunk kt's
// products run.  BN in {16, 32, 64, 128} is chosen per launch from M and
// Cout by the wrapper (ops/kernels/qconv.py:conv_tile) so that a launch
// has at least a block per SM with the widest tile, which reads x the
// fewest times.  The epilogue runs on the accumulators in registers, with
// the division-free exact quantizer compiled once per method
// (fq::quantize_inv_m: the same values as fq::quantize), and its results
// leave through the freed ring by 16-byte stores, coalesced along Cout.
// What still holds it back (ops/kernels/variants.py qconv, PERF.md section
// 6): the im2col gather reads each input value nine times from L2 (a
// third of the time at 56x56x64), the products and the output quant each
// about a fifth, overlapped only across the two or three blocks an SM
// holds.  A halo tile in shared memory read by ldmatrix into wgmma's
// register A operand would gather each value once.
// One kernel per (BN, output method): 12 kernels.
#include "gemm_sm90.cuh"

namespace {

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const float* aconsts;
  const float* scale;
  const float* shift;
  const void* res;
  void* out;
  int H, W, Cin, Cout, stride, Ho, Wo, M, activation;
  bool res_bf16, emit_norm;
};

// Dynamic shared memory of a BN-wide tile: the ring (as many stages as K
// needs), reused after the products to stage the output tile, a row per
// BN + 8 elements (the padding spreads the rows over the banks), plus 1024
// to align the base.
template <int BN>
struct ConvPlan {
  using P = sm90::Plan<BN>;
  static constexpr int OUT_BYTES = sm90::BM * (BN * 4 + 32);
  static constexpr int ring(int K) {
    const int kt = (K + sm90::BK - 1) / sm90::BK;
    return (kt < P::STAGES ? kt : P::STAGES) * P::STAGE_BYTES;
  }
  static constexpr int bytes(int K) {
    return (ring(K) > OUT_BYTES ? ring(K) : OUT_BYTES) + 1024;
  }
  static constexpr int MAX_BYTES = bytes(1 << 20);
};

// The output tile, staged row by row at ld bytes, to device memory: 16
// bytes a thread, consecutive threads along a row (Cout % 8 == 0, so no
// piece straddles Cout).
template <int BN, int ESIZE>
__device__ __forceinline__ void store_tile(const uint8_t* tile, void* out,
                                           int m0, int n0, int M, int Cout,
                                           int tid) {
  constexpr int PIECES = BN * ESIZE / 16, LD = BN * ESIZE + 8 * ESIZE;
  for (int i = tid; i < sm90::BM * PIECES; i += sm90::THREADS) {
    const int r = i / PIECES, p = i - r * PIECES;
    const int m = m0 + r, n = n0 + p * (16 / ESIZE);
    if (m < M && n < Cout)
      *reinterpret_cast<uint4*>(static_cast<uint8_t*>(out) +
                                (static_cast<long long>(m) * Cout + n) * ESIZE) =
          *reinterpret_cast<const uint4*>(tile + r * LD + p * 16);
  }
}

template <int BN, int METHOD>
__global__ void __launch_bounds__(sm90::THREADS, 2)
qconv3x3_kernel(const Args a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, K = 9 * a.Cin;

  ConvOperand A;
  A.init(a.x, a.H, a.W, a.Cin, a.Ho, a.Wo, a.stride, a.M, m0, tid);
  CopyOperand<BN> B;
  B.src = a.w; B.R = a.Cout; B.K = K; B.r0 = n0; B.tid = tid;
  float d[BN / 2];
  mainloop<BN>(A, B, d, smem, K, wg);
  __syncthreads();            // every warpgroup is done with the ring

  // Epilogue on the accumulators: thread (warp w, lane l) holds rows
  // 16w + l/4 (+8) of its warpgroup's 64 and column pairs 8j + 2(l%4).
  const fq::InvQuant q = fq::make_inv_quant(METHOD, fq::load_consts(a.aconsts, 1, 0));
  const int esize = a.emit_norm ? 2 : 4, ld = BN * esize + 8 * esize;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int rl = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = j * 8 + 2 * (lane & 3), n = n0 + cl;
    if (n >= a.Cout) continue;  // Cout % 8 == 0: n + 1 < Cout too
    const float2 sc = make_float2(__ldg(a.scale + n), __ldg(a.scale + n + 1));
    const float2 sh = make_float2(__ldg(a.shift + n), __ldg(a.shift + n + 1));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h, m = m0 + r;
      float y0 = __fadd_rn(__fmul_rn(d[4 * j + 2 * h], sc.x), sh.x);
      float y1 = __fadd_rn(__fmul_rn(d[4 * j + 2 * h + 1], sc.y), sh.y);
      if (a.res != nullptr && m < a.M) {
        const long long o = static_cast<long long>(m) * a.Cout + n;
        if (a.res_bf16) {
          const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(a.res) + o;
          y0 = __fadd_rn(y0, __bfloat162float(rb[0]));
          y1 = __fadd_rn(y1, __bfloat162float(rb[1]));
        } else {
          const float* rf = static_cast<const float*>(a.res) + o;
          y0 = __fadd_rn(y0, rf[0]);
          y1 = __fadd_rn(y1, rf[1]);
        }
      }
      y0 = fq::quantize_inv_m<METHOD>(fq::apply_act(y0, a.activation), q, a.emit_norm);
      y1 = fq::quantize_inv_m<METHOD>(fq::apply_act(y1, a.activation), q, a.emit_norm);
      uint8_t* dst = smem + r * ld + cl * esize;
      if (a.emit_norm)
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
    }
  }
  __syncthreads();
  if (a.emit_norm)
    store_tile<BN, 2>(smem, a.out, m0, n0, a.M, a.Cout, tid);
  else
    store_tile<BN, 4>(smem, a.out, m0, n0, a.M, a.Cout, tid);
}

template <int BN, int METHOD>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = qconv3x3_kernel<BN, METHOD>;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ConvPlan<BN>::MAX_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set = true;
  }
  const dim3 grid(static_cast<unsigned>((a.M + sm90::BM - 1) / sm90::BM),
                  static_cast<unsigned>((a.Cout + BN - 1) / BN));
  kernel<<<grid, sm90::THREADS, ConvPlan<BN>::bytes(9 * a.Cin), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int dispatch(const Args& a, int method, cudaStream_t st) {
  switch (method) {
    case fq::kQuantNone: return launch<BN, fq::kQuantNone>(a, st);
    case fq::kQuantFp8: return launch<BN, fq::kQuantFp8>(a, st);
    case fq::kQuantIntAsym: return launch<BN, fq::kQuantIntAsym>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (N, H, W, Cin) and w (Cout, 9*Cin) bf16, 16-byte aligned, Cin % 8 ==
// 0 and Cout % 8 == 0; a_method kQuantNone, kQuantFp8 or kQuantIntAsym by
// the (6, 1) aconsts; res (N, Ho, Wo, Cout) bf16 (res_bf16) or float32, or
// null; out bf16 (emit_norm) or float32.  bn: the tile width, one of 16,
// 32, 64, 128 (ops/kernels/qconv.py:conv_tile).
extern "C" int qconv3x3_launch(const void* x, const void* w,
                               const float* aconsts, const float* scale,
                               const float* shift, const void* res,
                               int res_bf16, void* out, int N, int H, int W,
                               int Cin, int Cout, int stride, int a_method,
                               int activation, int emit_norm, int bn,
                               void* stream) {
  if (Cin % 8 != 0 || Cout % 8 != 0 || (emit_norm && a_method == fq::kQuantNone))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.aconsts = aconsts; a.scale = scale; a.shift = shift; a.res = res;
  a.out = out; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
  a.stride = stride;
  a.Ho = (H - 1) / stride + 1;
  a.Wo = (W - 1) / stride + 1;
  a.M = N * a.Ho * a.Wo;
  a.activation = activation;
  a.res_bf16 = res_bf16 != 0;
  a.emit_norm = emit_norm != 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return dispatch<16>(a, a_method, st);
    case 32: return dispatch<32>(a, a_method, st);
    case 64: return dispatch<64>(a, a_method, st);
    case 128: return dispatch<128>(a, a_method, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Fused quant-matmul for Hopper: y = epilogue(q(x) @ q(w)^T).
//
// Replaces _qmatmul_kernel of fp8_quantization_tpu/ops/pallas/qmatmul.py
// (line 145, pallas_call at line 389).  x is (M, K) float32 or bf16, w is
// (N, K) row-major (torch's Linear layout): float32 to be quantized per
// output channel while it is staged (FP8, or int_sym on the calibrated
// signed or unsigned grid), or bf16 already on the normalized grid
// (baked).  With quantize_input, x is quantized while it is staged (FP8 or
// int_asym) and no output quant follows.  Operands enter the tensor cores
// as bf16 on the normalized grid, exact for <= 8-bit grids, and accumulate
// in fp32.  The epilogue folds the in-kernel weight factor and the input's
// factor back in, as the Pallas body does, then y*scale + shift,
// relu/relu6 and the optional output quant (FP8 or int_asym), stored as
// float32 or (emit_norm) as the normalized bf16 value.  Ragged M, N and K
// are masked in the kernel; the host makes no padded copies.
//
// Bound on the card: by its products alone the ViT's shapes (12,608 x
// 384 x 1152 and the like) would be bound by operations (989 TFLOP/s
// bf16 against 3.35 TB/s) and ResNet-18's and MobileNetV2's 1x1 shapes
// (K = 16..1280) by bytes; in fact the per-output epilogue bounds it at
// every shape: y*scale + shift and the FP8 or int_asym output quant
// (exponent read, IEEE division, rint) cost more issue slots than the
// products (ops/kernels/variants.py on the H100: the ViT's qkv product
// takes 0.038 ms with the raw sums stored and 0.083 ms with the epilogue).  Design (csrc/gemm_sm90.cuh): a 128 x
// BN x 64 block tile, BN in {16, 32, 64} chosen per launch from N by the
// wrapper (ops/kernels/qmatmul.py:tile_n) so that small-N layers keep a
// full tile and each block's epilogue stays short; a ring of 3
// shared-memory stages (as many as K needs) in the 128-byte-swizzled
// K-major layout that wgmma reads, so that three blocks fit on an SM and
// one block's epilogue overlaps another's products; bf16 operands (the
// baked w, and x when it is not quantized here) copied by 16-byte
// cp.async with zero fill past the edges, w's (N, K) rows being the
// K-major B operand as they are; float32 operands (x, and w quantized in
// the kernel) loaded with 16-byte loads, quantized (fq::quantize,
// unchanged) and stored into the stage while the asynchronous products of
// an earlier chunk run; two consumer warpgroups each issuing
// wgmma.mma_async m64nBNk16 for 64 rows; the epilogue on the accumulators
// in registers (fq::epilogue, unchanged, so -fmad=false rounds as the
// plain version does) with paired stores.  cp.async was chosen over TMA:
// it zero-fills ragged rows and the converting producers share its
// layout.  One kernel per tile width and operand kind (copied bf16 or
// converted float32): 12 kernels.
// Left for later: a cheaper exact epilogue (the division), TMA with a
// producer warp and setmaxnreg, a persistent tile scheduler that overlaps
// a tile's epilogue with the next tile's loads, clusters, the fp8 tensor
// cores, and one kernel per quantizer method (the method codes stay
// runtime values here).
#include "gemm_sm90.cuh"

namespace {

struct Args {
  const void* x;
  const void* w;
  const float* wconsts;
  const float* aconsts;
  const float* scale;
  const float* shift;
  void* out;
  int M, N, K, w_method, a_method, quantize_input, activation, emit_norm;
  bool x_vec, w_vec;
};

// What the epilogue of one output needs besides its accumulator.
struct Epilogue {
  const float* wconsts;   // row 5: the in-kernel weight factor
  const float* scale;
  const float* shift;
  void* out;
  int M, N, activation, out_method;
  bool w_factor, x_factor, bf16_out;
  fq::QuantConsts ac;
};

// Outputs (m, n), (m, n + 1), (m + 8, n), (m + 8, n + 1) from their fp32
// sums: the weight factor, the input's factor, y*scale + shift, the
// activation and the output quant (fq::epilogue), then paired stores.
// Inlined: a call per quad made the ViT's qkv product 1.8x slower
// (ops/kernels/variants.py on the H100).
__device__ __forceinline__ void store_quad(const Epilogue& e, int m, int n,
                                        float v00, float v01, float v10,
                                        float v11) {
  if (n >= e.N) return;
  const bool two = n + 1 < e.N, pairs = two && (e.N & 1) == 0;
  float wf[2], sc[2], sh[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int col = two ? n + c : n;
    wf[c] = e.w_factor ? e.wconsts[5 * e.N + col] : 1.0f;
    sc[c] = e.scale[col];
    sh[c] = e.shift[col];
  }
  const float v[2][2] = {{v00, v01}, {v10, v11}};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m + 8 * h;
    if (row >= e.M) continue;
    float y[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float t = v[h][c];
      if (e.w_factor) t = __fmul_rn(t, wf[c]);
      if (e.x_factor) t = __fmul_rn(t, e.ac.factor());
      y[c] = fq::epilogue(t, sc[c], sh[c], false, 0.0f, e.activation,
                          e.out_method, e.ac, e.bf16_out);
    }
    const long long o = static_cast<long long>(row) * e.N + n;
    if (pairs) {
      if (e.bf16_out)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(e.out) +
                                           o) =
            __halves2bfloat162(__float2bfloat16_rn(y[0]),
                               __float2bfloat16_rn(y[1]));
      else
        *reinterpret_cast<float2*>(static_cast<float*>(e.out) + o) =
            make_float2(y[0], y[1]);
    } else {
      fq::store_out(e.out, o, y[0], e.bf16_out);
      if (two) fq::store_out(e.out, o + 1, y[1], e.bf16_out);
    }
  }
}

template <bool COPY, int ROWS>
struct OperandOf {
  using type = sm90::ConvertOperand<ROWS>;
};
template <int ROWS>
struct OperandOf<true, ROWS> {
  using type = sm90::CopyOperand<ROWS>;
};

template <int ROWS>
__device__ __forceinline__ void setup(sm90::ConvertOperand<ROWS>& op,
                                      const void* src, bool vec, int method,
                                      const fq::QuantConsts& k,
                                      const float* row_consts) {
  op.src = static_cast<const float*>(src);
  op.vec = vec;
  op.method = method;
  op.tensor_consts = k;
  op.row_consts = row_consts;
}
template <int ROWS>
__device__ __forceinline__ void setup(sm90::CopyOperand<ROWS>& op,
                                      const void* src, bool, int,
                                      const fq::QuantConsts&, const float*) {
  op.src = static_cast<const __nv_bfloat16*>(src);
}

// XCOPY / WCOPY: the operand is bf16 on the grid and copied as it is;
// otherwise it is float32 and converted.
template <int BN, bool XCOPY, bool WCOPY>
__global__ void __launch_bounds__(sm90::THREADS, 2)
qmatmul_kernel(const Args args) {
  using namespace sm90;
  using P = Plan<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem_al = align1024(smem_raw);
  float* s_wc = reinterpret_cast<float*>(smem_al);
  uint8_t* smem = smem_al + P::STAGES_OFFSET;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int N = args.N, K = args.K;
  const fq::QuantConsts ac = fq::load_consts(args.aconsts, 1, 0);
  const int x_method = args.quantize_input ? args.a_method : fq::kQuantNone;
  const bool wq = args.w_method != fq::kQuantNone;
  if (wq)
    for (int i = tid; i < 6 * BN; i += THREADS) {
      const int row = i / BN, c = i - row * BN;
      s_wc[i] = n0 + c < N ? args.wconsts[row * N + n0 + c] : 0.0f;
    }
  __syncthreads();

  typename OperandOf<XCOPY, BM>::type a;
  a.R = args.M; a.K = K; a.r0 = m0; a.tid = tid;
  setup(a, args.x, args.x_vec, x_method, ac, nullptr);
  typename OperandOf<WCOPY, BN>::type b;
  b.R = N; b.K = K; b.r0 = n0; b.tid = tid;
  setup(b, args.w, args.w_vec, args.w_method, ac, wq ? s_wc : nullptr);

  float d[BN / 2];
  mainloop<BN>(a, b, d, smem, K, wg);

  // Epilogue from the accumulators: rows r and r + 8, column pairs.
  Epilogue e;
  e.wconsts = args.wconsts; e.scale = args.scale; e.shift = args.shift;
  e.out = args.out; e.M = args.M; e.N = N; e.activation = args.activation;
  e.out_method = args.quantize_input ? fq::kQuantNone : args.a_method;
  e.w_factor = wq; e.x_factor = x_method != fq::kQuantNone;
  e.bf16_out = args.emit_norm != 0; e.ac = ac;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int m = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    store_quad(e, m, n0 + j * 8 + 2 * (lane & 3), d[4 * j], d[4 * j + 1],
               d[4 * j + 2], d[4 * j + 3]);
}

template <int BN, bool XCOPY, bool WCOPY>
int launch(const Args& args, cudaStream_t stream) {
  auto kernel = qmatmul_kernel<BN, XCOPY, WCOPY>;
  const int smem = sm90::Plan<BN>::bytes(args.K);
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        sm90::Plan<BN>::MAX_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set = true;
  }
  const dim3 grid((args.M + sm90::BM - 1) / sm90::BM, (args.N + BN - 1) / BN);
  kernel<<<grid, sm90::THREADS, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int dispatch(const Args& args, bool x_copy, bool w_copy, cudaStream_t st) {
  if (x_copy)
    return w_copy ? launch<BN, true, true>(args, st)
                  : launch<BN, true, false>(args, st);
  return w_copy ? launch<BN, false, true>(args, st)
                : launch<BN, false, false>(args, st);
}

bool vector_ok(const void* p, int K, bool bf16) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && K % (bf16 ? 8 : 4) == 0;
}

}  // namespace

// w_method: kQuantNone (baked bf16 w), kQuantFp8 or kQuantIntSym (float32
// w, quantized per channel by the (6, N) wconsts); a_method: kQuantNone,
// kQuantFp8 or kQuantIntAsym, the input's quantizer under quantize_input,
// else the output's, by the (6, 1) aconsts.  bn: the tile width, one of
// 16, 32, 64 (ops/kernels/qmatmul.py:tile_n).  A bf16 operand is
// copied as it is and must be 16-byte aligned with K % 8 == 0, and x must
// be float32 under quantize_input (the wrapper converts otherwise).
extern "C" int qmatmul_launch(const void* x, int x_bf16, const void* w,
                              int w_bf16, const float* wconsts,
                              const float* aconsts, const float* scale,
                              const float* shift, void* out, int M, int N,
                              int K, int w_method, int a_method,
                              int quantize_input, int activation,
                              int emit_norm, int bn, void* stream) {
  Args args{x, w, wconsts, aconsts, scale, shift, out, M, N, K, w_method,
            a_method, quantize_input, activation, emit_norm,
            vector_ok(x, K, x_bf16 != 0), vector_ok(w, K, w_bf16 != 0)};
  if ((x_bf16 && (!args.x_vec || quantize_input)) ||
      (w_bf16 && (!args.w_vec || w_method != fq::kQuantNone)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const bool xc = x_bf16 != 0, wc = w_bf16 != 0;
  switch (bn) {
    case 16: return dispatch<16>(args, xc, wc, st);
    case 32: return dispatch<32>(args, xc, wc, st);
    case 64: return dispatch<64>(args, xc, wc, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

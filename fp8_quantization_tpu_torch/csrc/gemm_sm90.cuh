// Hopper GEMM building blocks of the port's quant-matmul (csrc/qmatmul.cu)
// and 3x3 conv (csrc/qconv.cu): a 128 x BN x 64 block tile whose bf16
// operands sit in shared memory in the 128-byte-swizzled K-major layout
// that wgmma reads, a ring of stages filled by 16-byte cp.async (bf16
// operands copied as they are, or gathered by the conv's implicit im2col)
// or by converting producers (float32 operands, quantized with
// fq::quantize while they are staged), and the wgmma.mma_async m64nBNk16
// bf16 -> fp32 products of two consumer warpgroups, each owning 64 rows
// of the tile (mainloop).
//
// Layout: one operand row (64 bf16 = 128 bytes) per smem row; the 16-byte
// chunk c of row r lies at chunk c ^ (r % 8) (the TMA/wgmma 128-byte
// swizzle), so eight rows form one 1024-byte swizzle atom.  Every stage
// and every operand base is 1024-byte aligned; a k16 step of the product
// advances the descriptor's start address by 32 bytes inside the atom.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fq_epilogue.cuh"

namespace sm90 {

constexpr int BM = 128, BK = 64, THREADS = 256, ROW_BYTES = BK * 2;

// Shared-memory plan of a BN-wide tile: the (6, BN) weight-quantizer
// constants, then a ring of STAGES x (A 128 rows + B BN rows) of 128
// bytes; a launch asks only for the stages its K uses (bytes(), plus 1024
// to align the base: a K of one or two chunks has nothing to pipeline),
// so a short K leaves room for more blocks on an SM.
template <int BN>
struct Plan {
  static constexpr int STAGES = 3;
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + BN * ROW_BYTES;
  static constexpr int STAGES_OFFSET = (6 * BN * 4 + 1023) / 1024 * 1024;
  static constexpr int MAX_BYTES = STAGES_OFFSET + STAGES * STAGE_BYTES + 1024;
  static int bytes(int K) {
    const int kt = (K + BK - 1) / BK;
    return STAGES_OFFSET + (kt < STAGES ? kt : STAGES) * STAGE_BYTES + 1024;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after ``p`` (dynamic shared memory
// is only 16-byte aligned; the launch asks for 1024 bytes more).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// Byte offset of 16-byte chunk ``c`` of row ``r`` in a swizzled operand.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return static_cast<uint32_t>(r * ROW_BYTES + ((c ^ (r & 7)) << 4));
}

// wgmma descriptor of a K-major operand with the 128-byte swizzle: start
// address, leading offset 1 (unused by swizzled K-major layouts), stride
// 1024 bytes between groups of eight rows, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes (st.shared, cp.async) made visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, both operands K-major in
// shared memory, D += A * B.  Accumulator i of a thread (lane l of warp w
// of the warpgroup) is row 16w + l/4 (+8 for i % 4 >= 2), column
// 8(i/4) + 2(l%4) + i%2.
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t da,
                                          uint64_t db) {
  if constexpr (BN == 16) wgmma_m64n16k16(d, da, db);
  else if constexpr (BN == 32) wgmma_m64n32k16(d, da, db);
  else if constexpr (BN == 64) wgmma_m64n64k16(d, da, db);
  else wgmma_m64n128k16(d, da, db);
}

// One 64-deep chunk for this warpgroup: rows [64 * wg, 64 * wg + 64) of
// the A stage against all BN rows of the B stage.
template <int BN>
__device__ __forceinline__ void mma_stage(float (&d)[BN / 2], uint32_t a_stage,
                                          uint32_t b_stage, int wg) {
  const uint64_t da = desc_sw128(a_stage + wg * 64 * ROW_BYTES);
  const uint64_t db = desc_sw128(b_stage);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)   // +32 bytes = +2 in the address field
    wgmma_k16<BN>(d, da + 2 * kk, db + 2 * kk);
  wgmma_commit();
}

// The K loop of one block over the ring of Plan<BN>::STAGES stages at
// ``smem`` (1024-byte aligned): the producers stage chunk kt + STAGES - 1
// right after the asynchronous products of chunk kt are issued, so the
// copies (or a converting producer's loads) run under the products.
// Leaves this warpgroup's sums in d and no copy in flight.
template <int BN, class AOperand, class BOperand>
__device__ __forceinline__ void mainloop(AOperand& a, BOperand& b,
                                         float (&d)[BN / 2], uint8_t* smem,
                                         int K, int wg) {
  using P = Plan<BN>;
  constexpr int S = P::STAGES;
  const uint32_t sbase = smem_addr(smem);
  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) {
      a.stage(s * BK, smem + s * P::STAGE_BYTES);
      b.stage(s * BK, smem + s * P::STAGE_BYTES + P::A_BYTES);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S - 2>();   // this thread's copies of chunk kt landed
    fence_proxy_async();
    __syncthreads();          // every thread's part of chunk kt is in place,
                              // and stage (kt - 1) % S is free again
    const uint32_t st = sbase + (kt % S) * P::STAGE_BYTES;
    fence_acc(d);
    mma_stage<BN>(d, st, st + P::A_BYTES, wg);
    const int nk = kt + S - 1;
    if (nk < KT) {            // under the products of chunk kt
      uint8_t* ns = smem + (nk % S) * P::STAGE_BYTES;
      a.stage(nk * BK, ns);
      b.stage(nk * BK, ns + P::A_BYTES);
    }
    cp_async_commit();
    wgmma_wait<0>();
    fence_acc(d);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Producers of one operand (R rows of K values, row-major in device memory;
// the stage holds rows r0 .. r0 + ROWS) into a swizzled stage, one 64-wide
// chunk at a time.  The mainloop calls stage() for chunk kt + STAGES - 1
// right after it has issued the asynchronous products of chunk kt, so the
// copies (or the loads of a converting producer) run under the products.
//
// Copy: bf16 already on the grid (K % 8 == 0, 16-byte aligned): one 16-byte
// cp.async per chunk of 8 values, zero-filled past M/N or K.
template <int ROWS>
struct CopyOperand {
  static constexpr int CHUNKS = ROWS * (BK / 8);
  const __nv_bfloat16* src;
  int R, K, r0, tid;

  __device__ __forceinline__ void stage(int k0, uint8_t* dst) {
    const uint32_t base = smem_addr(dst);
#pragma unroll
    for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (CHUNKS % THREADS != 0 && c >= CHUNKS) break;
      const int row = c >> 3, ch = c & 7, r = r0 + row, k = k0 + ch * 8;
      const bool ok = r < R && k < K;
      cp_async16(base + swizzled(row, ch),
                 ok ? src + static_cast<long long>(r) * K + k : src, ok);
    }
  }
};

// Convert: float32 values quantized by the quantizer of ``method`` (per
// tensor, or per row from (6, ROWS) constants in shared memory; kQuantNone
// rounds only) onto the normalized grid, rounded to bf16 and stored
// swizzled; 16-byte loads where ``vec`` (K % 4 == 0, 16-byte aligned).
template <int ROWS>
struct ConvertOperand {
  static constexpr int CHUNKS = ROWS * (BK / 8);
  const float* src;
  int R, K, r0, tid;
  bool vec;
  int method;
  fq::QuantConsts tensor_consts;   // per-tensor quantizer
  const float* row_consts;         // (6, ROWS) in shared memory, or null

  __device__ __forceinline__ void stage(int k0, uint8_t* dst) {
#pragma unroll 1
    for (int c = tid; c < CHUNKS; c += THREADS) {
      const int row = c >> 3, r = r0 + row, k = k0 + (c & 7) * 8;
      const float* p = src + static_cast<long long>(r) * K + k;
      float v[8];
      if (r < R && vec && k + 8 <= K) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = (r < R && k + e < K) ? p[e] : 0.0f;
      }
      fq::QuantConsts q = tensor_consts;
      if (row_consts != nullptr) {
#pragma unroll
        for (int j = 0; j < 6; ++j) q.r[j] = row_consts[j * ROWS + row];
      }
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __halves2bfloat162(
            __float2bfloat16_rn(fq::quantize(v[2 * e], method, q, true)),
            __float2bfloat16_rn(fq::quantize(v[2 * e + 1], method, q, true)));
        packed[e] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(dst + swizzled(row, c & 7)) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
};

// Implicit im2col of a 3x3 SAME conv (csrc/qconv.cu): row r of the A tile
// is output pixel m = r0 + r = (n, oh, ow) of the (N, Ho, Wo) map, and
// column k is tap (dy, dx) = divmod(k / Cin, 3), channel k % Cin of the
// bf16 NHWC input x at (oh * s + dy - 1, ow * s + dx - 1).  Cin % 8 == 0,
// so a 16-byte piece (8 channels) never straddles two taps: one cp.async
// a piece, zero-filled (src-size 0, at the same swizzled address) where
// the pixel lies outside the image, the row past M or the column past K.
// A thread owns piece tid % 8 of rows tid / 8 + 32 i: its tap is found
// once a chunk and its rows' coordinates once a block, so at Cin % 64 == 0
// (one tap a chunk, 128 contiguous bytes a row) the per-piece work is one
// bounds test and one address.
struct ConvOperand {
  static constexpr int ROWS = BM * (BK / 8) / THREADS;   // rows a thread
  const __nv_bfloat16* x;
  int H, W, Cin, K, tid;
  int img[ROWS];            // the row's image, n * H * W pixels
  int ih0[ROWS], iw0[ROWS]; // oh * s - 1, ow * s - 1; far outside past M

  __device__ __forceinline__ void init(const __nv_bfloat16* x_, int H_,
                                       int W_, int Cin_, int Ho, int Wo,
                                       int stride, int M, int r0, int tid_) {
    x = x_; H = H_; W = W_; Cin = Cin_; K = 9 * Cin_; tid = tid_;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int m = r0 + (tid >> 3) + 32 * i;
      img[i] = 0; ih0[i] = -4; iw0[i] = -4;
      if (m < M) {
        const int ow = m % Wo, t = m / Wo, oh = t % Ho;
        img[i] = (t / Ho) * H * W;
        ih0[i] = oh * stride - 1;
        iw0[i] = ow * stride - 1;
      }
    }
  }

  __device__ __forceinline__ void stage(int k0, uint8_t* dst) {
    const uint32_t base = smem_addr(dst);
    const int piece = tid & 7, k = k0 + piece * 8;
    const int tap = k / Cin, ci = k - tap * Cin;
    const int dy = tap / 3, dx = tap - 3 * dy;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int ih = ih0[i] + dy, iw = iw0[i] + dx;
      const bool ok = k < K && static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(W);
      const __nv_bfloat16* src =
          ok ? x + (static_cast<long long>(img[i] + ih * W + iw) * Cin + ci) : x;
      cp_async16(base + swizzled((tid >> 3) + 32 * i, piece), src, ok);
    }
  }
};

}  // namespace sm90

"""Timing of source variants of the redesigned kernels (no JAX
counterpart): which phase of ``csrc/qmatmul.cu``, ``csrc/qconv_int8.cu``,
``csrc/flash_mha.cu``, ``csrc/qblock.cu``, ``csrc/qconv.cu``,
``csrc/qmatmul_int8.cu``, ``csrc/qmatmul_s8_sm90.cu``, ``csrc/qdwconv.cu``
and ``csrc/qstem.cu`` holds each back on the card.

    python -m fp8_quantization_tpu_torch.ops.kernels.variants [--dry] [kernel ...]

Builds, with the flags of ``build.py``, patched copies of ``csrc/`` under
``build/variants/<kernel>_<n>/``, each with one phase removed or changed,
and prints one JSON line per (variant, shape) with the device ms of the
kernel alone (CUDA events; the calls are enqueued while the card spins, so
no host time counts).  A variant that removes a phase computes wrong
outputs by design: it only shows what that phase costs.  The kernels as
committed are checked against their plain versions by ``chip_smoke.py``.
``--dry`` applies the patches and exits (no card, no nvcc); kernel names
(qmatmul, qconv_int8, flash_mha, qblock, qconv, qmatmul_int8,
qmatmul_s8_sm90, qdwconv, qstem) restrict the run to those.

Shapes: the main path's qmatmul calls (bf16 x on the grid, baked bf16 w,
FP8 output quant, bf16 normalized output) at the ViT's qkv, proj and mlp2,
ResNet-18's first downsample and MobileNetV2's first expansion at batch
64, each at its ``tile_n`` width; qconv3x3_int8 at ResNet-18's seven 3x3
shapes at batch 64 with baked int8 weights, each at its ``conv_tile``;
flash_mha on ViT-S/16's (64, 6, 197, 64) float32 views of a qkv tensor;
qblock (FP8 stages, bf16 output) at five MobileNetV2 blocks at batch 64
(112x112 stride 2, 56x56 residual, 28x28 stride 2, 14x14 residual, 7x7
160->960->320), each
at its ``block_tile``; qconv3x3 (FP8 output quant, bf16 norms in and out)
at ResNet-18's seven 3x3 shapes at batch 64, each at its ``conv_tile``
width; qmatmul_int8 (baked int8 weights) at ResNet-18's three downsamples
and the fc at batch 64, each at its ``int8_tile``; qmatmul_s8_sm90 at the
ViT-S/16 INT8 block's qkv, proj and mlp2 (float32 out) and mlp1 (gelu, s8
out) at batch 64 and one 128 x 128 x 128 tile (the launch's floor), each
at its ``s8_tile`` and the other widths (the variants remove the TMA
loads, the products, the row and column sums, the epilogue, the output
stores, gelu and the s8 emission one at a time);
qdwconv3x3 (relu6, FP8
output quant, bf16 norms in and out) at MobileNetV2's ten depthwise shapes
at batch 64, each at its ``dw_tile``; qstem (FP8, bf16 norms out) at
ResNet-18's (64, 224, 224, 3) float32 images, at ``stem_tile``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import time

import torch

from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
from fp8_quantization_tpu_torch.ops.kernels import build, qstem
from fp8_quantization_tpu_torch.ops.kernels.attention import flash_grid
from fp8_quantization_tpu_torch.ops.kernels.qblock import block_tile
from fp8_quantization_tpu_torch.ops.kernels.qconv import conv_tile as qconv_tile
from fp8_quantization_tpu_torch.ops.kernels.qconv_int8 import conv_tile
from fp8_quantization_tpu_torch.ops.kernels.qdwconv import dw_tile
from fp8_quantization_tpu_torch.ops.kernels.qmatmul import tile_n
from fp8_quantization_tpu_torch.ops.kernels.qmatmul_int8 import int8_tile, s8_tile

VARIANTS_ROOT = build.BUILD_ROOT.parent / "variants"

# (variant, [(text in csrc/, replacement)]) per kernel
QMATMUL = [
    ("as committed", []),
    ("no epilogue: the raw sums stored", [(
        """    store_quad(e, m, n0 + j * 8 + 2 * (lane & 3), d[4 * j], d[4 * j + 1],
               d[4 * j + 2], d[4 * j + 3]);""",
        """    if (m < e.M && n0 + j * 8 + 2 * (lane & 3) < e.N)
      *reinterpret_cast<float2*>(static_cast<float*>(e.out) +
                                 static_cast<long long>(m) * e.N + n0 + j * 8 +
                                 2 * (lane & 3)) =
          make_float2(d[4 * j] + d[4 * j + 2], d[4 * j + 1] + d[4 * j + 3]);""")]),
    ("no products", [("    mma_stage<BN>(d, st, st + P::A_BYTES, wg);",
                      "    d[0] += 1.0f;")]),
    ("epilogue not inlined", [("__device__ __forceinline__ void store_quad(",
                               "__device__ __noinline__ void store_quad(")]),
    ("4 stages", [("  static constexpr int STAGES = 3;",
                   "  static constexpr int STAGES = 4;")]),
]
QCONV = [
    ("as committed", []),
    ("no division: inputs cast", [
        (f"v{i} = i8::quant_x(f.{c}, p);", f"v{i} = static_cast<int>(f.{c});")
        for i, c in enumerate("xyzw")]),
    ("no products", [(
        """          mma_s8(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * jp + 1], a[i], b[2], b[3]);""",
        """          acc[i][2 * jp][0] += a[i][0] ^ b[0];
          acc[i][2 * jp + 1][0] += a[i][1] ^ b[2];""")]),
    ("no epilogue: the raw sums stored", [(
        """          y[e] = i8::epilogue(acc[i][j][2 * h + e], s_rowsum[r], cs[e], K, p,
                              dw[e], sc[e], sh[e], activation);""",
        """          y[e] = static_cast<float>(acc[i][j][2 * h + e] + s_rowsum[r] + cs[e]);""")]),
]
FLASH = [
    ("as committed", []),
    ("no products", [(
        """wm::mma_bf16(s[2 * np], a, bk[0], bk[1]);""",
        """s[2 * np][0] += __uint_as_float(a[0] ^ bk[0]);"""), (
        """wm::mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);""",
        """s[2 * np + 1][0] += __uint_as_float(a[1] ^ bk[2]);"""), (
        """wm::mma_bf16(o[2 * dp], pa[kk], bv[0], bv[1]);""",
        """o[2 * dp][0] += __uint_as_float(pa[kk][0] ^ bv[0]);"""), (
        """wm::mma_bf16(o[2 * dp + 1], pa[kk], bv[2], bv[3]);""",
        """o[2 * dp + 1][0] += __uint_as_float(pa[kk][1] ^ bv[2]);""")]),
    ("no softmax (p = s)", [(
        """? expf(__fsub_rn(s[t][e], m_next[e >> 1]))""", """? s[t][e]""")]),
    ("no bf16 conversion pass", [(
        "    to_bf16(dst + r * LD + c, *reinterpret_cast<const Vec<T>*>(raw + r * D + c));",
        "    (void)dst;")]),
    ("q/K/V staging removed", [(
        "    wm::cp_async16(raw + r * D + c, src + (valid ? (r0 + r) * rs : 0) + c, valid);",
        "    (void)valid;")]),
]
QBLOCK = [
    ("as committed", []),
    ("no expand", [("    if (a.expand) {\n      const fq::InvQuant q_exp",
                    "    if (false) {\n      const fq::InvQuant q_exp")]),
    ("no stencil", [("  for (int o = o0; o0 < ostep && o < g.R; o += ostep) {",
                     "  for (int o = o0; false; o += ostep) {")]),
    ("no project", [("            wm::mma_bf16(acc[t], af, bf[0], bf[1]);",
                     "            acc[t][0] += __uint_as_float(af[0] ^ bf[0]);")]),
    ("stage quantizers off", [("  return fq::quantize_inv_m<M>(y, q, true);", "  return y;")]),
    ("first chunk only", [(
        "  const int nchunks = c_hi > c_lo ? (c_hi - c_lo + g.hc - 1) / g.hc : 0;",
        "  const int nchunks = c_hi > c_lo ? 1 : 0;")]),
    ("weights not restaged per chunk", [(
        "    if (ch + 1 < nchunks) {              // the next chunk under this one",
        "    if (false) {")]),
]
# wgmma_wait<1>: chunk kt's products run while chunk kt + 1 is waited for
INFLIGHT = [
    ("  for (int s = 0; s < S - 1; ++s) {", "  for (int s = 0; s < S - 2; ++s) {"),
    ("    cp_async_wait<S - 2>();   // this thread's copies of chunk kt landed",
     "    cp_async_wait<S - 3>();"),
    ("    const int nk = kt + S - 1;", "    const int nk = kt + S - 2;"),
    ("    wgmma_wait<0>();\n    fence_acc(d);\n  }\n  cp_async_wait<0>();",
     "    wgmma_wait<1>();\n    fence_acc(d);\n  }\n  wgmma_wait<0>();\n  fence_acc(d);\n"
     "  cp_async_wait<0>();")]
QCONV3X3 = [
    ("as committed", []),
    ("no output quant", [
        (f"  y{i} = fq::quantize_inv_m<METHOD>(fq::apply_act(y{i}, a.activation), q, "
         "a.emit_norm);", f"  y{i} = fq::apply_act(y{i}, a.activation);") for i in (0, 1)]),
    ("IEEE-division output quant (fq::quantize)", [
        (f"  y{i} = fq::quantize_inv_m<METHOD>(fq::apply_act(y{i}, a.activation), q, "
         "a.emit_norm);",
         f"  y{i} = fq::quantize(fq::apply_act(y{i}, a.activation), METHOD, q.k, a.emit_norm);")
        for i in (0, 1)]),
    ("no A gather (stale smem)", [(
        "      cp_async16(base + swizzled((tid >> 3) + 32 * i, piece), src, ok);",
        "      (void)src;")]),
    ("no copies (stale smem)", [(
        "      cp_async16(base + swizzled((tid >> 3) + 32 * i, piece), src, ok);",
        "      (void)src;"), (
        """      cp_async16(base + swizzled(row, ch),
                 ok ? src + static_cast<long long>(r) * K + k : src, ok);""",
        "      (void)ok;")]),
    ("no products", [("    mma_stage<BN>(d, st, st + P::A_BYTES, wg);",
                      "    d[0] += 1.0f;")]),
    ("no output stores", [("    if (m < M && n < Cout)\n", "    if (m < 0)\n")]),
    ("launch width 64", [("  switch (bn) {\n    case 16: return dispatch<16>(a, a_method, st);",
                          "  switch (64) {\n    case 16: return dispatch<16>(a, a_method, st);")]),
    ("launch width 128", [("  switch (bn) {\n    case 16: return dispatch<16>(a, a_method, st);",
                           "  switch (128) {\n    case 16: return dispatch<16>(a, a_method, st);")]),
    ("4 stages", [("  static constexpr int STAGES = 3;",
                   "  static constexpr int STAGES = 4;")]),
    ("4 stages, 2 product groups in flight", INFLIGHT + [(
        "  static constexpr int STAGES = 3;", "  static constexpr int STAGES = 4;")]),
    ("A copies through L1 (.ca)", [(
        "      cp_async16(base + swizzled((tid >> 3) + 32 * i, piece), src, ok);",
        "      asm volatile(\"cp.async.ca.shared.global [%0], [%1], 16, %2;\\n\" ::\"r\"(base + swizzled((tid >> 3) + 32 * i, piece)), \"l\"(src), \"r\"(ok ? 16 : 0) : \"memory\");")]),
]
QMATMUL_INT8 = [
    ("as committed", []),
    ("no x quantizer: inputs cast", [
        (f"i8::quant_x(xr[i].{c}, p)", f"static_cast<int>(xr[i].{c})") for c in "xyzw"]),
    ("no weight copies (stale smem)", [
        (f"          i8::{fn}(i8::saddr(&ws[buf][u * 16]), src, ok);", "          (void)src;")
        for fn in ("cp_async16_ca", "cp_async16")]),
    ("no products", [(
        """          i8::mma_s8(acc[i][2 * jp], af[i], b[0], b[1]);
          i8::mma_s8(acc[i][2 * jp + 1], af[i], b[2], b[3]);""",
        """          acc[i][2 * jp][0] += af[i][0] ^ b[0];
          acc[i][2 * jp + 1][0] += af[i][1] ^ b[2];""")]),
    ("no split-K reduction", [("      for (int k = 0; k < ranks; ++k) {\n",
                               "      for (int k = rank; k <= rank; ++k) {\n")]),
    ("no epilogue: the raw sums stored", [(
        """            y[e] = i8::epilogue(acc[i][j][2 * h + e], s_rowsum[rl], col[e], K, p,
                                dw[e], sc[e], sh[e], a.activation);""",
        """            y[e] = static_cast<float>(acc[i][j][2 * h + e]);""")]),
    ("no output stores", [("""          if (two && pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
          } else {
            o[0] = y[0];
            if (two) o[1] = y[1];
          }""", "          if (y[0] == 1234.5f) o[0] = y[1];")]),
    ("w copies through L2 only (.cg)", [("        if (a.w_l1)\n", "        if (false)\n")]),
    ("division-free x quantizer", [("  const float q = x == 0.0f ? 0.0f : __fdiv_rn(x, p.dx);",
                                      "  const float r = __frcp_rn(p.dx), q0 = __fmul_rn(x, r);\n  const float q = __fmaf_rn(__fmaf_rn(-q0, p.dx, x), r, q0);")]),
]
QMATMUL_S8 = [
    ("as committed", []),
    ("no TMA loads (full barriers arrive at once, stale smem)", [(
        """          mbar_arrive_tx(full + 8 * s, P::STAGE_BYTES);
          tma_load(st, &tm_x, full + 8 * s, kt * BK, m0);
          tma_load(st + P::A_BYTES, &tm_w, full + 8 * s, kt * BK, n0);""",
        """          mbar_arrive(full + 8 * s);
          (void)st; (void)m0; (void)n0;""")]),
    ("no products", [("        wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);",
                      "        acc[kk] += static_cast<int>(da >> 4) ^ static_cast<int>(db);")]),
    ("no row and column sums", [
        ("      if (col_sums && tw < BN / 2)\n        cs = bytes_sum",
         "      if (false)\n        cs = bytes_sum"),
        ("      if (rows)\n        rs = bytes_sum", "      if (false)\n        rs = bytes_sum")]),
    ("no epilogue (staging and float epilogue skipped)", [(
        "    for (int sl = 0; sl < BN / SLICE; ++sl) {",
        "    for (int sl = 0; sl < (M < 0 ? BN / SLICE : 0); ++sl) {")]),
    ("no output stores", [(
        "    store4<OUT>(a.out, static_cast<long long>(m) * a.N + n, min(4, a.N - n), vec, y, emit,",
        "    if (y[0] == 1234.5f)\n"
        "      store4<OUT>(a.out, static_cast<long long>(m) * a.N + n, min(4, a.N - n), vec, y,"
        " emit,")]),
    ("no gelu", [(
        "    return __fmul_rn(__fmul_rn(0.5f, y), erfcf(__fmul_rn(-y, kSqrtHalf)));",
        "    return y;")]),
    ("no s8 emission (a cast)", [(
        "    for (int e = 0; e < 4; ++e) q[e] = emit_s8(y[e], emit, inv);",
        "    for (int e = 0; e < 4; ++e) q[e] = static_cast<int>(y[e]);")]),
    ("epilogue pieces one at a time", [(
        "  constexpr int UNROLL = GELU ? 1 : 64 * PIECES / 128;",
        "  constexpr int UNROLL = 1;")]),
    ("epilogue pieces four at a time under gelu too", [(
        "  constexpr int UNROLL = GELU ? 1 : 64 * PIECES / 128;",
        "  constexpr int UNROLL = 64 * PIECES / 128;")]),
    ("emission by the IEEE division", [(
        """  const float q = fabsf(y) < 0.25f * e.dx ? 0.0f
                  : fabsf(q0) >= 16777216.0f ? q0
                  : __fmaf_rn(__fmaf_rn(-q0, e.dx, y), inv, q0);""",
        """  const float q = fabsf(y) < 0.25f * e.dx ? 0.0f : __fdiv_rn(y, e.dx);
  (void)q0;""")]),
    ("3 stages", [("constexpr int CONSUMERS = 2, THREADS = 128 * (CONSUMERS + 1), STAGES = 4;",
                   "constexpr int CONSUMERS = 2, THREADS = 128 * (CONSUMERS + 1), STAGES = 3;")]),
]
DW_QUANT = """        y[v] = fq::quantize_inv_m<METHOD>(
            fq::apply_act(__fadd_rn(__fmul_rn(acc[v], scv[v]), shv[v]), ACT), q, NORM);"""
DW_TILE = "  a.th = th; a.tw = tw; a.cg = cg;"
DW_STENCIL = """        acc[v] = __fmul_rn(col[S * j][0][v], wr[0][v]);
#pragma unroll
        for (int t = 1; t < 9; ++t)
          acc[v] = __fmaf_rn(col[S * j + t % 3][t / 3][v], wr[t][v], acc[v]);"""
QDWCONV = [
    ("as committed", []),
    ("no output quant", [(DW_QUANT, """        y[v] = fq::apply_act(__fadd_rn(__fmul_rn(acc[v], scv[v]), shv[v]), ACT);""")]),
    ("IEEE-division output quant (fq::quantize)", [(DW_QUANT, """        y[v] = fq::quantize(
            fq::apply_act(__fadd_rn(__fmul_rn(acc[v], scv[v]), shv[v]), ACT), METHOD, q.k,
            NORM);""")]),
    ("activation and output type chosen at run time", [(DW_QUANT, """        y[v] = fq::quantize_inv_m<METHOD>(
            fq::apply_act(__fadd_rn(__fmul_rn(acc[v], scv[v]), shv[v]), a.activation), q,
            a.emit_norm);"""), (
        "        store_vec<kVec>(a.out, out_row + static_cast<long long>(ow) * a.C, y, NORM);",
        "        store_vec<kVec>(a.out, out_row + static_cast<long long>(ow) * a.C, y, a.emit_norm);")]),
    ("no halo staging (stale smem)", [(
        "      wm::cp_async16(halo + r * a.rp + c * a.cg + v, src, ok);", "      (void)src;")]),
    ("no stencil (the centre tap's reads only)", [(DW_STENCIL, """        acc[v] = col[S * j + 1][1][v];""")]),
    ("stencil as separate multiplies and adds", [(DW_STENCIL, """        acc[v] = __fmul_rn(col[S * j][0][v], wr[0][v]);
#pragma unroll
        for (int t = 1; t < 9; ++t)
          acc[v] = __fadd_rn(acc[v], __fmul_rn(col[S * j + t % 3][t / 3][v], wr[t][v]));""")]),
    ("no output stores", [("      if (ow < a.Wo)\n", "      if (ow < a.Wo && y[0] == 1234.5f)\n")]),
    ("4 channels a thread (about 110 registers)", [(
        "constexpr int kVec = 2;", "constexpr int kVec = 4;")]),
    ("tiles 7 wide (a strip a thread)", [(DW_TILE, "  a.th = th; a.tw = 7; a.cg = cg;")]),
    ("tiles at most 14 wide", [(DW_TILE, "  a.th = th; a.tw = tw < 14 ? tw : 14; a.cg = cg;")]),
    ("tiles 4 rows high", [(DW_TILE, "  a.th = th < 4 ? th : 4; a.tw = tw; a.cg = cg;")]),
    ("tiles twice as high where the map allows", [(
        DW_TILE, "  a.th = th >= 7 && a.Ho % (2 * th) == 0 ? 2 * th : th; a.tw = tw; a.cg = cg;")]),
    ("tiles 56 wide at stride 1 where the map allows", [(
        DW_TILE, "  a.th = th; a.tw = tw == 28 && a.Wo % 56 == 0 ? 56 : tw; a.cg = cg;")]),
    ("channel groups of at most 2 vectors", [(
        DW_TILE, "  a.th = th; a.tw = tw; a.cg = cg < 2 ? cg : 2;")]),
]
STEM_TILE = "  g.tp = tp; g.tq = tq;"
QSTEM = [
    ("as committed", []),
    ("no output quant", [(
        "      for (int e = 0; e < 8; ++e) y[e] = fq::quantize_inv_m<METHOD>(y[e], quant, g.emit_norm);",
        "      for (int e = 0; e < 8; ++e) y[e] = y[e] + 0.0f;")]),
    ("no patch loads (stale smem)", [(
        "          put<XT>(g, patch, pr, chunk_base<XT>(s, i - pr * g.nch), s, raw[k]);",
        "          (void)s;"), (
        "      stage_rest<XT>(g, patch, nn, np0, nq0, tid + MAXCH * THREADS);\n", "")]),
    ("no products", [(
        """          wm::mma_bf16(acc[2 * p], a, b[0], b[1]);
          wm::mma_bf16(acc[2 * p + 1], a, b[2], b[3]);""",
        """          acc[2 * p][0] += __uint_as_float(a[0] ^ b[0]);
          acc[2 * p + 1][0] += __uint_as_float(a[1] ^ b[2]);""")]),
    ("no pool (the centre pixel)", [
        ("      for (int dr = 0; dr < 3; ++dr)", "      for (int dr = 1; dr < 2; ++dr)"),
        ("        for (int dc = 0; dc < 3; ++dc) {", "        for (int dc = 1; dc < 2; ++dc) {")]),
    ("no output stores", [(
        "      const long long o = ((static_cast<long long>(n) * g.P + p) * g.P + q) * COUT + 8 * oct;",
        "      if (y[0] != 1234.5f) continue;\n"
        "      const long long o = ((static_cast<long long>(n) * g.P + p) * g.P + q) * COUT + 8 * oct;")]),
    ("tiles 8 x 14 (one block an SM)", [(STEM_TILE, "  g.tp = tp; g.tq = tq == 8 ? 14 : tq;")]),
    ("tiles 4 x 8", [(STEM_TILE, "  g.tp = tp == 8 ? 4 : tp; g.tq = tq;")]),
]
KERNEL_VARIANTS = {"qmatmul": QMATMUL, "qconv_int8": QCONV, "flash_mha": FLASH,
                   "qblock": QBLOCK, "qconv": QCONV3X3, "qmatmul_int8": QMATMUL_INT8,
                   "qmatmul_s8_sm90": QMATMUL_S8, "qdwconv": QDWCONV, "qstem": QSTEM}
MATMUL_SHAPES = [(64 * 197, 384, 1152), (64 * 197, 384, 384), (64 * 197, 1536, 384),
                 (64 * 28 * 28, 64, 128), (64 * 112 * 112, 16, 96)]
INT8_MATMUL_SHAPES = [(64 * 28 * 28, 64, 128), (64 * 14 * 14, 128, 256),
                      (64 * 7 * 7, 256, 512), (64, 512, 1000)]
# (label, M, K, N, activation code, output kind 0 float32 / 2 s8); one
# 128 x 128 x 128 tile times the launch's floor
S8_MATMUL_SHAPES = [("qkv", 64 * 197, 384, 1152, 0, 0), ("proj", 64 * 197, 384, 384, 0, 0),
                    ("mlp2", 64 * 197, 1536, 384, 0, 0), ("mlp1", 64 * 197, 384, 1536, 3, 2),
                    ("one tile", 128, 128, 128, 0, 0)]
CONV_SHAPES = [(56, 64, 64, 1), (56, 64, 128, 2), (28, 128, 128, 1), (28, 128, 256, 2),
               (14, 256, 256, 1), (14, 256, 512, 2), (7, 512, 512, 1)]
# (H, C, stride) of MobileNetV2's ten depthwise shapes (224x224 input)
DW_SHAPES = [(112, 32, 1), (112, 96, 2), (56, 144, 1), (56, 144, 2), (28, 192, 1),
             (28, 192, 2), (14, 384, 1), (14, 576, 1), (14, 576, 2), (7, 960, 1)]
# (H, stride, Cin, hid, Cout, residual)
BLOCK_SHAPES = [(112, 2, 16, 96, 24, False), (56, 1, 24, 144, 24, True), (28, 2, 32, 192, 64, False),
                (14, 1, 96, 576, 96, True), (7, 1, 160, 960, 320, False)]


def patched_copy(name: str, index: int, patches) -> str:
    """A copy of csrc/ with ``patches`` applied; returns its directory."""
    out = VARIANTS_ROOT / f"{name}_{index}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    for old, new in patches:
        hits = 0
        for path in out.iterdir():
            text = path.read_text()
            if old in text:
                hits += 1
                path.write_text(text.replace(old, new))
        if hits == 0:
            raise RuntimeError(f"{name} variant {index}: patch not found:\n{old}")
    return str(out)


def build_variants(name: str, variants, dry: bool):
    """[(variant, C entry)] for every variant of kernel ``name``, all built
    at once (one nvcc each)."""
    dirs = [patched_copy(name, i, p) for i, (_, p) in enumerate(variants)]
    if dry:
        return []
    procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", f"{d}/lib.so",
                               f"{d}/{name}.cu"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for d in dirs]
    entries = []
    for (label, _), d, proc in zip(variants, dirs, procs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} / {label}: nvcc failed\n{log}")
        fn_name, argtypes = build.SIGNATURES[name]
        fn = getattr(ctypes.CDLL(f"{d}/lib.so"), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries.append((label, fn))
    return entries


def device_ms(call, iters=20):
    """Device ms per call, the calls enqueued while the card spins."""
    for _ in range(3):
        build.check(call(), "variant")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * host_s + 2e-4, 1.0) * 1.98e9))
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def matmul_calls(g):
    """(shape, call(fn)) of the main path's qmatmul calls."""
    stream = torch.cuda.current_stream().cuda_stream
    for m, k, n in MATMUL_SHAPES:
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device="cuda") * 0.05).to(torch.bfloat16)
        scale = torch.full((n,), 0.01, device="cuda")
        shift = torch.zeros(n, device="cuda")
        a_c = fp8_consts(torch.tensor([4.0], device="cuda"), 4)
        w_c = torch.zeros(6, 1, device="cuda")
        out = torch.empty(m, n, device="cuda")      # room for float32 sums
        args = (x.data_ptr(), 1, w.data_ptr(), 1, w_c.data_ptr(), a_c.data_ptr(),
                scale.data_ptr(), shift.data_ptr(), out.data_ptr(), m, n, k,
                0, 1, 0, 0, 1, tile_n(n), stream)
        yield [m, k, n], (lambda fn, a=args: fn(*a))


def conv_calls(g):
    """(shape, call(fn)) of ResNet-18's 3x3 convs on the int8 datapath."""
    stream = torch.cuda.current_stream().cuda_stream
    for h, cin, cout, s in CONV_SHAPES:
        x = torch.relu(torch.randn(64, h, h, cin, generator=g, device="cuda"))
        w = torch.randint(-127, 128, (cout, 9 * cin), generator=g, device="cuda",
                          dtype=torch.int8)
        w_delta = torch.full((cout,), 0.01, device="cuda")
        w_scalars = torch.tensor([0.0, 1.0], device="cuda")
        a_scalars = torch.tensor([0.02, 3.0, 0.0], device="cuda")
        scale, shift = torch.ones(cout, device="cuda"), torch.zeros(cout, device="cuda")
        ho = (h - 1) // s + 1
        out = torch.empty(64, ho, ho, cout, device="cuda")
        t = conv_tile(ho, ho, s, cout)
        args = (x.data_ptr(), w.data_ptr(), 1, w_delta.data_ptr(), w_scalars.data_ptr(),
                a_scalars.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
                64, h, h, cin, cout, s, 8, 8, 1, t.bm, t.th, t.tw, t.bn, stream)
        yield [h, cin, cout, s], (lambda fn, a=args: fn(*a))


def qconv_calls(g):
    """(shape, call(fn)) of ResNet-18's 3x3 convs on the FP8 datapath: bf16
    norms in, baked bf16 weights, relu, FP8 output quant, bf16 norms out."""
    stream = torch.cuda.current_stream().cuda_stream
    a_c = fp8_consts(torch.tensor([4.0], device="cuda"), 4)
    for h, cin, cout, s in CONV_SHAPES:
        x = torch.randn(64, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(cout, 9 * cin, generator=g, device="cuda") * 0.05).to(torch.bfloat16)
        scale = torch.full((cout,), 0.01, device="cuda")
        shift = torch.zeros(cout, device="cuda")
        ho = (h - 1) // s + 1
        out = torch.empty(64, ho, ho, cout, device="cuda", dtype=torch.bfloat16)
        bn = qconv_tile(64 * ho * ho, cout).bn
        keep = (x, w, scale, shift, out)
        args = (x.data_ptr(), w.data_ptr(), a_c.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), None, 0, out.data_ptr(), 64, h, h, cin, cout, s, 1, 1,
                1, bn, stream)
        yield [h, cin, cout, s, bn], (lambda fn, a=args, k=keep: fn(*a))


def int8_matmul_calls(g):
    """(shape, call(fn)) of ResNet-18's qmatmul_int8 calls (the 1x1/2
    downsamples and the fc), float32 x, baked int8 weights."""
    stream = torch.cuda.current_stream().cuda_stream
    w_scalars = torch.tensor([0.0, 1.0], device="cuda")
    a_scalars = torch.tensor([0.02, 3.0, 0.0], device="cuda")
    for m, k, n in INT8_MATMUL_SHAPES:
        x = torch.relu(torch.randn(m, k, generator=g, device="cuda"))
        w = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        w_delta = torch.full((n,), 0.01, device="cuda")
        scale, shift = torch.ones(n, device="cuda"), torch.zeros(n, device="cuda")
        out = torch.empty(m, n, device="cuda")
        t = int8_tile(m, n, k)
        keep = (x, w, w_delta, scale, shift, out)
        args = (x.data_ptr(), w.data_ptr(), 1, 0, w_delta.data_ptr(), w_scalars.data_ptr(),
                a_scalars.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
                m, n, k, 8, 8, 0, t.bm, t.bn, t.splits, stream)
        yield [m, k, n, t.bm, t.bn, t.splits], (lambda fn, a=args, kp=keep: fn(*a))


def s8_matmul_calls(g):
    """(shape, call(fn)) of the ViT-S/16 INT8 block's four products at batch
    64 on the Hopper s8 kernel, baked signed weights: qkv, proj and mlp2
    with float32 outputs, mlp1 with gelu and s8 out, each at its
    ``s8_tile`` and at the other widths."""
    stream = torch.cuda.current_stream().cuda_stream
    w_scalars = torch.tensor([0.0, 1.0], device="cuda")
    a_scalars = torch.tensor([0.02, 130.0, 0.0], device="cuda")
    e_scalars = torch.tensor([0.05, 3.6], device="cuda")
    for label, m, k, n, act, kind in S8_MATMUL_SHAPES:
        x = torch.randint(-128, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        w_delta = torch.full((n,), 0.01, device="cuda")
        scale, shift = torch.ones(n, device="cuda"), torch.zeros(n, device="cuda")
        out = torch.empty(m, n, device="cuda", dtype=torch.int8 if kind else torch.float32)
        keep = (x, w, w_delta, scale, shift, out)
        rule = s8_tile(m, n)
        for bn in (rule,) + tuple(b for b in (128, 192, 256) if b != rule):
            args = (x.data_ptr(), w.data_ptr(), w_delta.data_ptr(), w_scalars.data_ptr(),
                    a_scalars.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                    e_scalars.data_ptr(), out.data_ptr(), m, n, k, 8, act, kind, 8, bn,
                    stream)
            yield [label, m, k, n, bn], (lambda fn, a=args, kp=keep: fn(*a))


def flash_calls(g):
    """(shape, call(fn)) of the ViT's attention call."""
    stream = torch.cuda.current_stream().cuda_stream
    b, s, h, d = 64, 197, 6, 64
    qkv = torch.randn(b, s, 3, h, d, generator=g, device="cuda")
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = torch.empty(b, s, h, d, device="cuda")
    groups, warps, _ = flash_grid(s)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), 0, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], out.data_ptr(), b, h, s, d, groups,
            warps, d ** -0.5, stream)
    yield [b, h, s, d], (lambda fn, a=args, keep=qkv: fn(*a))


def block_calls(g):
    """(shape, call(fn)) of four MobileNetV2 blocks, FP8 stages."""
    stream = torch.cuda.current_stream().cuda_stream
    a_c = fp8_consts(torch.full((4,), 4.0, device="cuda"), 4).contiguous()
    for hgt, s, cin, hid, cout, res in BLOCK_SHAPES:
        x = torch.randn(64, hgt, hgt, cin, generator=g, device="cuda").to(torch.bfloat16)
        w1 = (torch.randn(cin, hid, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        wd = torch.randn(3, 3, hid, generator=g, device="cuda").to(torch.bfloat16).float()
        w2 = (torch.randn(hid, cout, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        vec = [torch.full((n,), v, device="cuda") for n, v in
               ((hid, 0.5), (hid, 0.1), (hid, 0.3), (hid, 0.1), (cout, 0.2), (cout, 0.0))]
        xf = torch.ones((), device="cuda")
        ho = (hgt - 1) // s + 1
        out = torch.empty(64, ho, ho, cout, device="cuda", dtype=torch.bfloat16)
        t = block_tile(hgt, hgt, s, cin, hid, cout, True)
        keep = (x, w1, wd, w2, vec, xf, out, a_c)
        args = (x.data_ptr(), w1.data_ptr(), wd.data_ptr(), w2.data_ptr(), a_c.data_ptr(),
                *(v.data_ptr() for v in vec), xf.data_ptr(), out.data_ptr(), 64, hgt, hgt,
                cin, hid, cout, s, 1, int(res), 0b01010101, 1, 1, t.th, t.tw, t.cs, t.hc,
                t.warps, t.maxt, stream)
        yield [hgt, s, cin, hid, cout, res], (lambda fn, a=args, k=keep: fn(*a))


def dw_calls(g):
    """(shape, call(fn)) of MobileNetV2's depthwise convs: bf16 norms in,
    relu6, FP8 output quant, bf16 norms out, each at its ``dw_tile``."""
    stream = torch.cuda.current_stream().cuda_stream
    a_c = fp8_consts(torch.tensor([4.0], device="cuda"), 4)
    for h, c, s in DW_SHAPES:
        x = torch.randn(64, h, h, c, generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randn(3, 3, c, generator=g, device="cuda").to(torch.bfloat16).float()
        scale = torch.full((c,), 0.5, device="cuda")
        shift = torch.zeros(c, device="cuda")
        ho = (h - 1) // s + 1
        out = torch.empty(64, ho, ho, c, device="cuda", dtype=torch.bfloat16)
        t = dw_tile(h, h, c, s)
        keep = (x, w, scale, shift, out)
        args = (x.data_ptr(), w.data_ptr(), a_c.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), out.data_ptr(), 64, h, h, c, s, 1, 2, 1, t.th, t.tw,
                t.cg, stream)
        yield [h, c, s, t.th, t.tw, t.cg], (lambda fn, a=args, k=keep: fn(*a))


def stem_calls(g):
    """(shape, call(fn)) of ResNet-18's stem: (64, 224, 224, 3) float32
    images, FP8 output quant, bf16 norms out, at ``stem_tile``."""
    stream = torch.cuda.current_stream().cuda_stream
    a_c = fp8_consts(torch.tensor([4.0], device="cuda"), 4)
    x = torch.randn(64, 224, 224, 3, generator=g, device="cuda")
    w = qstem.weight_matrix(torch.randn(64, 3, 7, 7, generator=g, device="cuda") * 0.05)
    scale = torch.full((64,), 0.5, device="cuda")
    shift = torch.zeros(64, device="cuda")
    out = torch.empty(64, 56, 56, 64, device="cuda", dtype=torch.bfloat16)
    t = qstem.stem_tile(224)
    keep = (x, w, scale, shift, out)
    args = (x.data_ptr(), 0, w.data_ptr(), w.shape[0], a_c.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), 64, 224, 3, 1, 1, t.tp, t.tq, stream)
    yield [64, 224, 3, t.tp, t.tq], (lambda fn, a=args, k=keep: fn(*a))


def main(argv) -> int:
    dry = "--dry" in argv
    only = [a for a in argv if not a.startswith("--")] or list(KERNEL_VARIANTS)
    if not dry and not torch.cuda.is_available():
        print("variants: needs a CUDA card (or --dry)", file=sys.stderr)
        return 2
    built = {name: build_variants(name, variants, dry)
             for name, variants in KERNEL_VARIANTS.items() if name in only}
    if dry:
        print("variants: every patch applies")
        return 0
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, calls in (("qmatmul", matmul_calls(g)), ("qconv_int8", conv_calls(g)),
                        ("flash_mha", flash_calls(g)), ("qblock", block_calls(g)),
                        ("qconv", qconv_calls(g)),
                        ("qmatmul_int8", int8_matmul_calls(g)),
                        ("qmatmul_s8_sm90", s8_matmul_calls(g)),
                        ("qdwconv", dw_calls(g)), ("qstem", stem_calls(g))):
        if name not in only:
            continue
        for shape, call in calls:
            for label, fn in built[name]:
                print(json.dumps({"kernel": name, "shape": shape, "variant": label,
                                  "ms": device_ms(lambda: call(fn))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

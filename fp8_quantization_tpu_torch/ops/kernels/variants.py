"""Timing of source variants of the two redesigned kernels (no JAX
counterpart): which phase of ``csrc/qmatmul.cu`` and ``csrc/qconv_int8.cu``
holds each back on the card.

    python -m fp8_quantization_tpu_torch.ops.kernels.variants [--dry]

Builds, with the flags of ``build.py``, patched copies of ``csrc/`` under
``build/variants/<kernel>_<n>/``, each with one phase removed or changed,
and prints one JSON line per (variant, shape) with the device ms of the
kernel alone (CUDA events; the calls are enqueued while the card spins, so
no host time counts).  A variant that removes a phase computes wrong
outputs by design: it only shows what that phase costs.  The kernels as
committed are checked against their plain versions by ``chip_smoke.py``.
``--dry`` applies the patches and exits (no card, no nvcc).

Shapes: the main path's qmatmul calls (bf16 x on the grid, baked bf16 w,
FP8 output quant, bf16 normalized output) at the ViT's qkv, proj and mlp2,
ResNet-18's first downsample and MobileNetV2's first expansion at batch
64, each at its ``tile_n`` width; qconv3x3_int8 at ResNet-18's seven 3x3
shapes at batch 64 with baked int8 weights, each at its ``conv_tile``.
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
from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.ops.kernels.qconv_int8 import conv_tile
from fp8_quantization_tpu_torch.ops.kernels.qmatmul import tile_n

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
MATMUL_SHAPES = [(64 * 197, 384, 1152), (64 * 197, 384, 384), (64 * 197, 1536, 384),
                 (64 * 28 * 28, 64, 128), (64 * 112 * 112, 16, 96)]
CONV_SHAPES = [(56, 64, 64, 1), (56, 64, 128, 2), (28, 128, 128, 1), (28, 128, 256, 2),
               (14, 256, 256, 1), (14, 256, 512, 2), (7, 512, 512, 1)]


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


def main(argv) -> int:
    dry = "--dry" in argv
    if not dry and not torch.cuda.is_available():
        print("variants: needs a CUDA card (or --dry)", file=sys.stderr)
        return 2
    built = {name: build_variants(name, variants, dry)
             for name, variants in (("qmatmul", QMATMUL), ("qconv_int8", QCONV))}
    if dry:
        print("variants: every patch applies")
        return 0
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, calls in (("qmatmul", matmul_calls(g)), ("qconv_int8", conv_calls(g))):
        for shape, call in calls:
            for label, fn in built[name]:
                print(json.dumps({"kernel": name, "shape": shape, "variant": label,
                                  "ms": device_ms(lambda: call(fn))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one JSON line each (a failed phase prints "ok": false and the
script exits 1 without the final result line):

1. env      - card name and power limit (nvidia-smi), torch and nvcc
              versions, the kernels' build from csrc/ (one nvcc per source,
              all started together) and its seconds.
2. check    - each kernel against its plain PyTorch version on the card at
              the main path's shapes, batch 64: qmatmul at the three
              downsample shapes, the fc and one in-kernel FP8-weight case;
              qconv3x3 at ResNet-18's seven 3x3 shapes plus one residual
              case; qstem at (64, 224, 224, 3).  Holds if >= 99% of elements
              are exact and the rest within one FP8 grid step (the kernel
              sums in another order than cuDNN/cuBLAS in fp32).
3. slice    - the main path as a user runs it: validate-quantized through
              the CLI's entry point (cli/image_net.validate_quantized) on
              ResNet-18 at full width with random torchvision-layout
              weights from the seed and synthetic 224x224 data: calibrate 1
              batch, bake, evaluate 2 batches with engine='fused'.  Launch
              counts are zeroed just before and read just after: exactly 1
              stem, 16 conv3x3 and 4 qmatmul per forward.  Then the same
              calibrated state under 'fused' and 'bf16' on the same batches:
              logits finite, top-1 agreeing on >= 99% of images and >= 98%
              of logits within one grid step of the fc's output quantizer.
4. timing   - per kernel, summed over one ResNet-18 forward at batch 64:
              CUDA-event ms of the kernel, of its plain version, of one
              PyTorch call computing the same function (library_ms: bf16
              channels-last F.conv2d, torch.matmul, F.conv2d + max_pool2d)
              and the bound max(bytes / 3.35 TB/s, flops / 989 TFLOP/s); and
              images/s of engine 'fused' against 'bf16' at batch 64 and 256,
              timed in turns (fused, bf16, bf16, fused, ...), each turn's ms
              listed and images/s from their median.
5. profile  - torch.profiler over three fused forwards at batch 64: device
              time per forward by kernel name (the port's three kernels and
              the top PyTorch kernels), kernel launches per forward and the
              device's idle share of the wall time ("not measured" if the
              profiler records no device time).

Then a {"kernels": [...]} line, the nvidia-smi name/power-limit line, and
last {"ok": true, "device": {...}}.  The plain versions run with TF32 off.
"""

import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
BATCH = 64
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
MBITS = 4                          # E3M4, the main path's format
THROUGHPUT_TURNS = 2               # pairs of (fused, bf16) / (bf16, fused)

# (H, Cin, Cout, stride, uses per ResNet-18 forward) of the 3x3 convs
CONV_SHAPES = [(56, 64, 64, 1, 4), (56, 64, 128, 2, 1), (28, 128, 128, 1, 3),
               (28, 128, 256, 2, 1), (14, 256, 256, 1, 3), (14, 256, 512, 2, 1),
               (7, 512, 512, 1, 3)]
# (M, K, N, out) of the qmatmul calls: the 1x1/2 downsamples and the fc
MATMUL_SHAPES = [(BATCH * 28 * 28, 64, 128, "norm"), (BATCH * 14 * 14, 128, 256, "norm"),
                 (BATCH * 7 * 7, 256, 512, "norm"), (BATCH, 512, 1000, "value")]


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def nvcc_version():
    from fp8_quantization_tpu_torch.ops.kernels.build import _nvcc
    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[-1]


def time_ms(fn, iters=20):
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved, flops):
    return 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)


def grid_check(out, ref, consts, normalized):
    """(ok, max_abs_err, exact share): >= 99% exact, the rest within one
    FP8 grid step (2^-M of the larger magnitude, plus the smallest step)."""
    import torch
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    min_step = 2.0 ** (1.0 + float(consts[4, 0]))
    if not normalized:
        min_step *= float(consts[5, 0])
    step = torch.maximum(a.abs(), b.abs()) * 2.0 ** -MBITS + min_step
    exact = float((diff == 0).float().mean())
    ok = bool(torch.isfinite(a).all()) and bool((diff <= step).all()) and exact >= 0.99
    return ok, float(diff.max()), exact


class Inputs:
    """Random operands on the card from one seeded generator."""

    def __init__(self):
        import torch
        self.g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(self, *shape, scale=1.0):
        import torch
        return torch.randn(*shape, generator=self.g, device="cuda") * scale

    def uniform(self, n, lo, hi):
        import torch
        return torch.rand(n, generator=self.g, device="cuda") * (hi - lo) + lo

    def norms(self, *shape, maxval=4.0):
        """Activations on the normalized E3M4 grid, bf16 (a factored input)."""
        import torch
        from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts, fp8_quantize_prepared
        c = fp8_consts(torch.tensor([maxval], device="cuda"), MBITS)
        return fp8_quantize_prepared(self.randn(*shape), c,
                                     normalized=True).to(torch.bfloat16).contiguous()

    def weight_norms(self, w):
        """Per-output-channel normalized weights (dim 0), float32 values."""
        from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts, fp8_quantize_prepared
        c = fp8_consts(w.abs().reshape(w.shape[0], -1).amax(dim=1), MBITS)
        return fp8_quantize_prepared(w, c, channel_axis=0, normalized=True)


def out_consts(y0):
    import torch
    from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
    return fp8_consts(torch.tensor([0.8 * float(y0.abs().max())], device="cuda"), MBITS)


def matmul_cases(inp):
    """(name, args, cfg, flops, bytes, uses, library fn) per qmatmul case."""
    import torch
    from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
    from fp8_quantization_tpu_torch.ops.kernels import qmatmul as qm
    cases = []
    for M, K, N, out in MATMUL_SHAPES + [(BATCH, 512, 1000, "fp8w")]:
        x = inp.norms(M, K)
        scale, shift = inp.uniform(N, 0.005, 0.015), inp.randn(N, scale=0.1)
        if out == "fp8w":      # weights quantized in the kernel (not baked)
            w = inp.randn(N, K, scale=0.02).contiguous()
            w_c = fp8_consts(w.abs().amax(dim=1), MBITS)
            wm = "fp8"
        else:
            w = inp.weight_norms(inp.randn(N, K, scale=0.05)).to(torch.bfloat16)
            w_c, wm = None, "none"
        emit_norm = out == "norm"
        y0 = qm.qmatmul_plain(x, w, w_c, None, scale, shift,
                              qm.FusedQuantMatmulConfig(weight_method=wm))
        cfg = qm.FusedQuantMatmulConfig(weight_method=wm, act_method="fp8",
                                        emit_norm=emit_norm)
        args = (x, w, w_c, out_consts(y0), scale, shift)
        out_bytes = M * N * (2 if emit_norm else 4)
        nbytes = x.numel() * 2 + w.numel() * w.element_size() + out_bytes
        xt, wt = x, w.to(torch.bfloat16).t()
        cases.append((f"qmatmul {M}x{K}x{N} {out}", args, cfg, 2 * M * N * K,
                      nbytes, 0 if out == "fp8w" else 1,
                      lambda xt=xt, wt=wt: torch.matmul(xt, wt)))
    return cases


def conv_cases(inp):
    import torch
    import torch.nn.functional as F
    from fp8_quantization_tpu_torch.ops.kernels import qconv as qc
    cases = []
    for H, cin, cout, s, uses in CONV_SHAPES + [(28, 128, 128, 1, 0)]:
        residual = uses == 0
        x = inp.norms(BATCH, H, H, cin)
        w4 = inp.weight_norms(inp.randn(cout, cin, 3, 3, scale=0.05))
        w = qc.weight_matrix(w4)
        scale, shift = inp.uniform(cout, 0.005, 0.015), inp.randn(cout, scale=0.1)
        ho = (H - 1) // s + 1
        res = inp.norms(BATCH, ho, ho, cout).float() if residual else None
        y0 = qc.qconv3x3_plain(x, w, None, scale, shift, res,
                               qc.FusedConvConfig(stride=s, residual=residual))
        cfg = qc.FusedConvConfig(act_method="fp8", activation="relu",
                                 residual=residual, emit_norm=True, stride=s)
        args = (x, w, out_consts(y0), scale, shift, res)
        flops = 2 * BATCH * ho * ho * 9 * cin * cout
        nbytes = x.numel() * 2 + w.numel() * 2 + BATCH * ho * ho * cout * 2
        if residual:
            nbytes += res.numel() * res.element_size()
        xl = x.permute(0, 3, 1, 2)                  # NCHW view, channels-last
        wl = w4.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        name = f"qconv3x3 {H}x{H}x{cin}->{cout} s{s}" + (" residual" if residual else "")
        cases.append((name, args, cfg, flops, nbytes, uses,
                      lambda xl=xl, wl=wl, s=s: F.conv2d(xl, wl, stride=s, padding=1)))
    return cases


def stem_cases(inp):
    import torch
    import torch.nn.functional as F
    from fp8_quantization_tpu_torch.ops.kernels import qstem as qs
    x = inp.randn(BATCH, 224, 224, 3).contiguous()
    w4 = inp.weight_norms(inp.randn(64, 3, 7, 7, scale=0.05))
    w = qs.weight_matrix(w4)
    scale, shift = inp.uniform(64, 0.5, 1.5), inp.randn(64, scale=0.1)
    y0 = qs.qstem_plain(x, w, None, scale, shift, qs.FusedStemConfig(act_method="none"))
    cfg = qs.FusedStemConfig(act_method="fp8", emit_norm=True)
    args = (x, w, out_consts(y0), scale, shift)
    flops = 2 * BATCH * 112 * 112 * 147 * 64
    nbytes = x.numel() * 4 + w.numel() * 2 + BATCH * 56 * 56 * 64 * 2
    xl = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    wl = w4.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    lib = lambda: F.max_pool2d(F.conv2d(xl, wl, stride=2, padding=3), 3, 2, 1)  # noqa: E731
    return [("qstem 224x224x3->64", args, cfg, flops, nbytes, 1, lib)]


def kernel_table():
    """name -> (wrapper, plain, module) of the three kernels."""
    from fp8_quantization_tpu_torch.ops.kernels import qconv, qmatmul, qstem
    return {
        "qstem": (qstem.fused_quant_stem, qstem.qstem_plain, qstem),
        "qconv3x3": (qconv.fused_quant_conv3x3, qconv.qconv3x3_plain, qconv),
        "qmatmul": (qmatmul.fused_quant_matmul, qmatmul.qmatmul_plain, qmatmul),
    }


def phase_check_and_time(results):
    """Phases 2 and 4 for the kernels: one pass over the cases, holding each
    against its plain version and timing kernel, plain and library call."""
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    inp = Inputs()
    table = kernel_table()
    ok_all = True
    for kname, make in (("qstem", stem_cases), ("qconv3x3", conv_cases),
                        ("qmatmul", matmul_cases)):
        wrapper, plain, _ = table[kname]
        agg = results.setdefault(kname, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                             bound_ms=0.0, library_ms=0.0))
        for name, args, cfg, flops, nbytes, uses, lib in make(inp):
            out = wrapper(*args, cfg=cfg)
            with no_tf32():
                ref = plain(*args, cfg)
            consts = args[3] if kname == "qmatmul" else args[2]
            ok, err, exact = grid_check(out, ref, consts, getattr(cfg, "emit_norm", False))
            ms = time_ms(lambda: wrapper(*args, cfg=cfg))
            with no_tf32():
                pms = time_ms(lambda: plain(*args, cfg), iters=5)
            lms = time_ms(lib)
            bms = bound_ms(nbytes, flops)
            emit({"phase": "check", "case": name, "ok": ok, "max_abs_err": err,
                  "exact": exact, "ms": ms, "plain_ms": pms, "library_ms": lms,
                  "bound_ms": bms, "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                  > flops / BF16_FLOPS_PER_S else "operations",
                  "uses_per_forward": uses})
            ok_all &= ok
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            if uses:
                for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                             ("bound_ms", bms)):
                    agg[k] += uses * v
                agg["bytes"] = agg.get("bytes", 0) + uses * nbytes
                agg["flops"] = agg.get("flops", 0) + uses * flops
    return ok_all


EVAL_BATCHES = 2
# validate-quantized as a user runs it: the main path's config (bench.py's
# ResNet-18 FP8 row without the TPU deploy flags), synthetic data, random
# torchvision-layout weights from the seed
CLI_ARGS = ["validate-quantized", "--device", "cuda", "--engine", "fused",
            "--architecture", "resnet18_quantized", "--per-channel",
            "--fp8-set-maxval", "--fp8-mantissa-bits", str(MBITS),
            "--weight-quant-method", "current_minmax",
            "--act-quant-method", "allminmax", "--num-est-batches", "1",
            "--max-eval-batches", str(EVAL_BATCHES), "--batch-size", str(BATCH),
            "--seed", str(SEED)]


def phase_slice(results):
    """The main path through the CLI's entry point, then fused against bf16
    on the same calibrated state."""
    from itertools import islice

    import torch
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    from fp8_quantization_tpu_torch.nn.bake import bake_weights
    from fp8_quantization_tpu_torch.ops import kernels

    args = image_net.build_parser().parse_args(CLI_ARGS)
    kernels.reset_launch_counts()
    metrics = image_net.validate_quantized(args)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {"qstem": EVAL_BATCHES, "qconv3x3": 16 * EVAL_BATCHES,
            "qmatmul": 4 * EVAL_BATCHES}

    _, val = make_dataloaders(None, batch_size=BATCH, seed=SEED)
    batches = list(islice(iter(val), EVAL_BATCHES))
    fused = image_net.build_model(args)
    calibrate(fused, batches[:1], device="cuda", num_batches=1)
    bf16 = image_net.build_model(image_net.build_parser().parse_args(
        CLI_ARGS + ["--engine", "bf16"]))
    bf16.load_state_dict(fused.state_dict())
    bake_weights(fused)
    bake_weights(bf16)
    agree, exact, within, finite = [], [], [], True
    with torch.no_grad():
        for x, _ in batches:
            xt = torch.as_tensor(x, device="cuda")
            a = fused(xt, mode="fixed", quant_w=False)
            b = bf16(xt, mode="fixed", quant_w=False)
            finite &= bool(torch.isfinite(a).all())
            agree.append(float((a.argmax(-1) == b.argmax(-1)).float().mean()))
            # one grid step of the fc's E3M4 output quantizer
            step = (torch.maximum(a.abs(), b.abs()) * 2.0 ** -MBITS
                    + float(fused.fc.act_q.maxval) * 2.0 ** -10)
            within.append(float(((a - b).abs() <= step).float().mean()))
            exact.append(float((a == b).float().mean()))
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    ok = (counts == want and finite and math.isfinite(metrics["loss"])
          and metrics["num_examples"] == BATCH * EVAL_BATCHES
          and mean(agree) >= 0.99 and mean(within) >= 0.98)
    emit({"phase": "slice", "ok": ok, "metrics": metrics, "launches": counts,
          "expected_launches": want, "logits_finite": finite,
          "top1_agree_vs_bf16": mean(agree),
          "logits_within_one_step_vs_bf16": mean(within),
          "logits_exact_vs_bf16": mean(exact)})
    for k, v in counts.items():
        results.setdefault(k, {})["launches"] = v
    return ok, fused, bf16


def phase_throughput(fused, bf16):
    """Forward ms of both engines, in turns (fused, bf16, bf16, fused, ...)
    so that a drift of the host or the card falls on both; images/s from
    the median of the turns."""
    import statistics

    import torch
    rows = {}
    with torch.no_grad():
        for batch in (BATCH, 256):
            x = torch.randn(batch, 224, 224, 3, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1))
            turns = {"fused": [], "bf16": []}
            for order in ("fused", "bf16") * THROUGHPUT_TURNS:
                models = (("fused", fused), ("bf16", bf16))
                for name, model in (models if order == "fused" else models[::-1]):
                    turns[name].append(time_ms(
                        lambda: model(x, mode="fixed", quant_w=False), iters=10))
            for name, ms in turns.items():
                med = statistics.median(ms)
                rows[f"{name}_b{batch}"] = {"ms": ms, "median_ms": med,
                                            "images_per_s": batch / med * 1e3}
    emit({"phase": "throughput", "ok": True, **rows})


def phase_profile(fused):
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(BATCH, 224, 224, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    n = 3
    with torch.no_grad():
        fused(x, mode="fixed", quant_w=False)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fused(x, mode="fixed", quant_w=False)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, us / 1e3 / n, e.count / n))
    if not rows:
        emit({"phase": "profile", "ok": True, "device_time": "not measured",
              "wall_ms_per_forward": wall_ms})
        return True
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ours = {k: sum(r[1] for r in rows if k + "_kernel" in r[0])
            for k in ("qstem", "qconv3x3", "qmatmul")}
    emit({"phase": "profile", "ok": True, "wall_ms_per_forward": wall_ms,
          "device_busy_ms_per_forward": busy,
          "idle_share": max(0.0, 1.0 - busy / wall_ms),
          "launches_per_forward": sum(r[2] for r in rows),
          "port_kernels_ms": ours,
          "other_ms": busy - sum(ours.values()),
          "top": [{"name": r[0][:80], "ms": r[1], "calls": r[2]} for r in rows[:12]]})
    return True


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from fp8_quantization_tpu_torch.ops.kernels import build
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32

    ok_all = True
    smi = smi_line()
    build_s = build.build_all()
    emit({"phase": "env", "ok": True, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_version(),
          "device": torch.cuda.get_device_name(0), "build_s": build_s})

    results = {}
    phases = [("check", lambda: phase_check_and_time(results))]
    slice_out = {}

    def run_slice():
        ok, fused, bf16 = phase_slice(results)
        slice_out.update(fused=fused, bf16=bf16)
        return ok

    phases.append(("slice", run_slice))
    phases.append(("throughput", lambda: phase_throughput(slice_out["fused"],
                                                           slice_out["bf16"]) or True))
    phases.append(("profile", lambda: phase_profile(slice_out["fused"])))
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            with no_tf32():
                ok = bool(fn())
        except Exception:  # noqa: BLE001 - report the phase and go on
            traceback.print_exc()
            ok = False
        emit({"phase": name + "_done", "ok": ok, "s": time.perf_counter() - t0})
        ok_all &= ok

    table = kernel_table()
    rows = []
    for name, (_, _, mod) in table.items():
        r = results.get(name, {})
        rows.append({"name": name, "route": "cuda",
                     "source": f"fp8_quantization_tpu_torch/csrc/{mod.__name__.split('.')[-1]}.cu",
                     "replaces": mod.REPLACES, "launches": r.get("launches"),
                     "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
                     "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
                     "bound_by": ("bytes" if r.get("bytes", 0) / HBM_BYTES_PER_S
                                  > r.get("flops", 0) / BF16_FLOPS_PER_S else "operations"),
                     "library_ms": r.get("library_ms")})
    emit({"kernels": rows})
    print(smi, flush=True)
    if not ok_all:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

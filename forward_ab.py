#!/usr/bin/env python3
"""Forward time of two checkouts of the PyTorch/CUDA port on one GPU, in turns.

    python3 forward_ab.py OLD_CHECKOUT NEW_CHECKOUT [--rounds 2]

Runs one process per turn, in the order old, new, new, old (``--rounds``
times), so that a drift of the host or the card falls on both.  Each
process imports the port from its checkout, builds that checkout's kernels,
builds ResNet-18 FP8 and ResNet-18 INT8 at full width through the
checkout's ``validate-quantized`` flags (the main paths of ``chip_smoke.py``,
random weights from seed 0, synthetic data), calibrates on one batch of 64,
bakes, and times the deployed ``fused`` forward at batch 64: CUDA events,
``REPS`` timings of ``ITERS`` forwards, their median.  One JSON line per
turn, then a summary (per checkout and model: every turn's median and
their median) and the ``nvidia-smi`` name / power-limit line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

BATCH = 64
SEED = 0
REPS, ITERS = 5, 10
COMMON = ["validate-quantized", "--device", "cuda", "--engine", "fused",
          "--architecture", "resnet18_quantized", "--per-channel",
          "--weight-quant-method", "current_minmax",
          "--act-quant-method", "allminmax", "--num-est-batches", "1",
          "--batch-size", str(BATCH), "--seed", str(SEED)]
MODELS = {
    "resnet18_fp8": COMMON + ["--fp8-set-maxval", "--fp8-mantissa-bits", "4"],
    "resnet18_int8": COMMON + ["--qmethod", "symmetric_uniform",
                               "--qmethod-act", "asymmetric_uniform",
                               "--quantize-input", "--int8-mxu"],
}


def child(checkout):
    """Time the two models of one checkout; print one JSON line."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    from fp8_quantization_tpu_torch.ops.kernels import build
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32

    build.build_all()
    _, val = make_dataloaders(None, batch_size=BATCH, seed=SEED)
    batch = next(iter(val))
    x = torch.randn(BATCH, 224, 224, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    row = {"checkout": checkout}
    with no_tf32(), torch.no_grad():
        for name, flags in MODELS.items():
            model = image_net.build_model(image_net.build_parser().parse_args(flags))
            calibrate(model, [batch], device="cuda", num_batches=1)
            quant_w = image_net.bake_for_eval(model, True, True)
            for _ in range(3):
                model(x, mode="fixed", quant_w=quant_w)
            times = []
            for _ in range(REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(ITERS):
                    model(x, mode="fixed", quant_w=quant_w)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / ITERS)
            row[name] = {"ms": times, "median_ms": statistics.median(times)}
    print(json.dumps(row), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("old")
    p.add_argument("new")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        return child(args.old)
    import torch
    if not torch.cuda.is_available():
        print("forward_ab: CUDA is not available", file=sys.stderr)
        return 2
    medians = {c: {m: [] for m in MODELS} for c in ("old", "new")}
    for label in ("old", "new", "new", "old") * args.rounds:
        checkout = getattr(args, label)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), checkout, checkout,
             "--child"], capture_output=True, text=True, timeout=600, check=True)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": label, **row}), flush=True)
        for m in MODELS:
            medians[label][m].append(row[m]["median_ms"])
    summary = {c: {m: {"turn_medians_ms": v, "median_ms": statistics.median(v)}
                   for m, v in per.items()} for c, per in medians.items()}
    print(json.dumps({"summary": summary, "batch": BATCH}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

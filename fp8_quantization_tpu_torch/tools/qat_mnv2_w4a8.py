"""The paper's headline QAT experiment at model scale, on synthetic data.

The port's counterpart of ``tools/qat_mnv2_w4a8.py``: full-depth
MobileNetV2 with the fc4_dw8 preset (4-bit weights, 8-bit depthwise convs,
stem and classifier, 8-bit activations) and classifier dropout 0.2, in
three phases with JAX's hyperparameters:

1. fp32 pretraining (quantizers off, BN on batch statistics, Adam 3e-3);
2. W4A8 PTQ (calibration on two batches, then the quantized evaluation);
3. QAT through the STE with learned ranges: SGD 3e-3 (momentum 0.9,
   cosine to 0) on the weights, a separate Adam 1e-4 on the ranges,
   oscillation dampening (1e-5 -> 1e-4) and freezing (0.005 -> 0.02).

It prints one JSON line: the three top-1s, the QAT trajectory (one top-1
per epoch), ms per step of both training phases (the steps alone; JAX's
QAT figure also holds each epoch's evaluation, and its fp32 one the
compilation) and the device (``torch.cuda.get_device_name()`` on the
card, ``"cpu"`` on the host).
Real ImageNet numbers need real data; this runs the same machinery at full
depth on the device.  The weights start from ``--seed``'s random draw in
the tonylins layout (models/convert.py).

    python -m fp8_quantization_tpu_torch.tools.qat_mnv2_w4a8      # the card
    python -m fp8_quantization_tpu_torch.tools.qat_mnv2_w4a8 --smoke --device cpu

``--smoke`` runs JAX's CI sizes: 32 px, batch 16, 4 batches, 8 + 4 epochs,
a three-block MobileNetV2.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# the dropout seed of the pretraining step (JAX folds the step into key 5)
PRETRAIN_DROPOUT_SEED = 5
SMOKE_SETTINGS = ((1, 8, 1, 1), (6, 12, 2, 2), (6, 16, 2, 2))


def w4a8_config():
    """fc4_dw8's base config: W4 per channel symmetric, A8 asymmetric,
    min/max ranges (BASELINE.json config 5's quantizers)."""
    from fp8_quantization_tpu_torch.nn.config import make_layer_config
    return make_layer_config(
        qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
        n_bits=4, n_bits_act=8, per_channel_weights=True,
        weight_range_method="current_minmax", act_range_method="allminmax")


def fp32_step(state, x, y):
    """One step of the fp32 pretraining (JAX's ``fp32_step``): quantizers
    off, BN on the batch's statistics, dropout from the step's generator,
    the model optimizer alone.  In place; returns ``(state, loss)``."""
    from fp8_quantization_tpu_torch.training.qat import (
        _device, _step_optimizer, cross_entropy)

    model = state.model
    dev = _device(model)
    x = torch.as_tensor(x).to(dev, torch.float32)
    y = torch.as_tensor(y).to(dev, torch.long)
    if hasattr(model, "dropout_generator"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(PRETRAIN_DROPOUT_SEED * 2 ** 32 + state.step)
        model.dropout_generator = gen
    logits = model(x, mode="fp32", quant_w=False, quant_a=False, train_bn=True)
    loss = cross_entropy(logits, y)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    _step_optimizer(state.optimizer, state.model_tx, state.step)
    state.step += 1
    return state, loss.detach()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="qat_mnv2_w4a8")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes and few steps: a proof of the pipeline")
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--fp32-epochs", type=int, default=30)
    ap.add_argument("--qat-epochs", type=int, default=20)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    from fp8_quantization_tpu_torch.calibration.calibrate import (
        calibrate, evaluate)
    from fp8_quantization_tpu_torch.data.imagenet import SyntheticImageNet
    from fp8_quantization_tpu_torch.device import resolve_device
    from fp8_quantization_tpu_torch.models import convert
    from fp8_quantization_tpu_torch.models.mobilenet_v2 import (
        INVERTED_RESIDUAL_SETTING, mobilenetv2_quantized)
    from fp8_quantization_tpu_torch.training.oscillation import (
        OscillationConfig)
    from fp8_quantization_tpu_torch.training.qat import (
        init_qat_state, make_optimizer, make_train_step)

    args = build_parser().parse_args(argv)
    if args.smoke:
        args.image_size, args.batch, args.batches = 32, 16, 4
        args.fp32_epochs, args.qat_epochs = 8, 4
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    t_start = time.perf_counter()

    def mark(msg):
        print(f"[qat +{time.perf_counter() - t_start:6.1f}s] {msg}", flush=True)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    config = w4a8_config()
    settings = SMOKE_SETTINGS if args.smoke else INVERTED_RESIDUAL_SETTING
    model = mobilenetv2_quantized(config, quant_setup="fc4_dw8",
                                  num_classes=args.classes, settings=settings,
                                  device=device, dropout_rate=0.2)
    convert.load_tonylins_mobilenet_v2(model, convert.random_mobilenet_v2_state_dict(
        args.seed, settings, args.classes))
    batches = list(SyntheticImageNet(image_size=args.image_size,
                                     batch_size=args.batch,
                                     num_batches=args.batches,
                                     num_classes=args.classes, seed=0))
    val = list(SyntheticImageNet(image_size=args.image_size,
                                 batch_size=args.batch, num_batches=4,
                                 num_classes=args.classes, seed=1))
    mark(f"data ready ({args.batches}x{args.batch} train @ "
         f"{args.image_size}px, {args.classes} classes)")

    def top1(**kw):
        return evaluate(model, val, device=device, **kw)["top_1_accuracy"]

    # ---- phase 1: fp32 pretraining (quantizers off) ------------------------
    state = init_qat_state(model, config, make_optimizer("Adam", 3e-3))
    sync()
    t0, n_steps = time.perf_counter(), 0
    for _ in range(args.fp32_epochs):
        for x, y in batches:
            state, loss = fp32_step(state, x, y)
            n_steps += 1
    sync()
    fp32_ms = (time.perf_counter() - t0) / n_steps * 1e3
    fp32_loss = float(loss)
    fp32_top1 = top1(quant_w=False, quant_a=False)
    mark(f"fp32 pretrain: {n_steps} steps, {fp32_ms:.1f} ms/step, "
         f"top-1 {fp32_top1:.3f}")

    # ---- phase 2: W4A8 PTQ ---------------------------------------------------
    calibrate(model, [x for x, _ in batches[:2]], device=device)
    ptq_top1 = top1()
    mark(f"W4A8 fc4_dw8 PTQ: top-1 {ptq_top1:.3f} (fp32 {fp32_top1:.3f})")

    # ---- phase 3: QAT with oscillation dampening and freezing ---------------
    total_qat = args.qat_epochs * len(batches)
    osc = OscillationConfig(
        dampen_weight=1e-5, dampen_weight_final=1e-4,
        freeze_threshold=0.005, freeze_threshold_final=0.02,
        freeze_ema_momentum=0.99, total_steps=total_qat)
    state = init_qat_state(
        model, config,
        make_optimizer("SGD", 3e-3, scheduler="cosine:0", max_steps=total_qat,
                       momentum=0.9),
        make_optimizer("Adam", 1e-4), oscillation=osc)
    step = make_train_step(state, mode="learn")
    traj, losses, frozen = [], [], {}
    sync()
    t0, n_steps, train_s = time.perf_counter(), 0, 0.0
    for epoch in range(args.qat_epochs):
        for x, y in batches:
            state, m = step(state, x, y)
            n_steps += 1
        sync()
        train_s += time.perf_counter() - t0
        losses.append(m["loss"])
        traj.append(round(float(top1()), 4))
        frozen = {k: round(float(v), 4) for k, v in m.items()
                  if k.startswith("frozen")}
        mark(f"QAT epoch {epoch}: val top-1 {traj[-1]:.3f} "
             f"train loss {m['loss']:.3f} {frozen}")
        t0 = time.perf_counter()
    qat_ms = train_s / n_steps * 1e3 if n_steps else float("nan")
    qat_top1 = top1()
    result = {
        "config": "mobilenet_v2 W4A8 fc4_dw8 + oscillation damp/freeze",
        "image_size": args.image_size, "batch": args.batch,
        "classes": args.classes,
        "fp32_top1": round(float(fp32_top1), 4),
        "ptq_top1": round(float(ptq_top1), 4),
        "qat_top1": round(float(qat_top1), 4),
        "trajectory": traj,
        "fp32_ms_per_step": round(fp32_ms, 1),
        "qat_ms_per_step": round(qat_ms, 1),
        "qat_steps": n_steps,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
    }
    print(json.dumps(result), flush=True)
    # beside the JAX result: the last losses and the frozen shares
    result.update(fp32_loss=fp32_loss, qat_losses=losses, **frozen)
    if args.smoke:
        # the machinery runs end to end and QAT does not make it worse
        if result["qat_top1"] < result["ptq_top1"] - 0.05:
            raise SystemExit(f"qat_mnv2_w4a8: QAT top-1 below PTQ's: {result}")
    return result


if __name__ == "__main__":
    main()

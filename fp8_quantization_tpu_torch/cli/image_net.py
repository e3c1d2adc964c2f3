"""ImageNet PTQ entry point of the port: ``validate-quantized``.

Mirrors ``validate-quantized`` of ``cli/image_net.py`` (lines 247-334):
calibrate -> freeze -> bake -> evaluate, printing the same JSON metrics
line.  The flag names are the JAX CLI's, plus ``--device {cuda,cpu}`` and
``--engine {parity,bf16,fused}``; ``--deploy-cast-quant``,
``--conv-out-bf16`` and ``--deploy-act-f8`` are JAX's deployment flags
(there lines 107-122; ``deploy_cast_ieee`` and ``int8_assume_signed`` are
config-only there and here).  Three differences: ``--bake-weights`` is
on by default (the fused engine's kernels for the stem, the 3x3 convs, the
depthwise convs and the MobileNetV2 blocks need baked weights); after the
bake the ``bf16`` and ``fused`` engines run the prepare pass
(``nn/bake.prepare_inference``, as ``bench.py`` deploys every row through
``prepare_for_deployment_host``), which changes no value and so has no
flag; and without ``--model-dir`` the weights are random in the torchvision (ResNet),
tonylins (MobileNetV2) or timm (ViT-S/16) layout, made from ``--seed``.
Range methods include ``MSE`` (the grid search with the mantissa-bit
sweep and vote, ``--num-candidates``, ``--act-num-candidates``,
``--fp8-mse-include-mantissa-bits``) and ``line_search``;
``--format-search-passes N`` then reallocates each FP8 quantizer's
mantissa bits by N sweeps of coordinate descent on the logits' error
(calibration/format_search.py) before the bake.  ``--stem-s2d`` (ResNet
only, JAX there lines 125-128, 179-181) runs the stem as the exact
space-to-depth 4x4/1 conv (ops/s2d.py); the images stay (N, 224, 224,
3).  Under the int8 datapath
(``--int8-mxu --quantize-input`` with symmetric weights and asymmetric
inputs) the bake is ``bake_int8_weights`` and the model is evaluated with
``quant_w=True``, as ``bench.py`` does (lines 107-111): the JAX CLI's
``bake_weights`` bakes nothing there and then evaluates unquantized
weights (ROADMAP.md, section C).

Checkpoints (utils/checkpoint.py, JAX there lines 142-150, 264-291,
589-591): ``validate-quantized --save-checkpoint-dir`` saves the
calibrated model right after calibration (before the BN re-estimation,
the format search, the bake and the prepare pass), and ``--load-type
quantized --load-checkpoint-dir`` restores it into the freshly built model
instead of calibrating (``quantized`` without a directory is a usage
error, as in JAX); ``train-quantized --save-checkpoint-dir`` saves the QAT
state after each epoch's evaluation as step ``epoch``, keeping the newest.
``--deterministic`` (both commands, off by default) seeds Python's
``random``, numpy and torch from ``--seed``, as JAX seeds Python and numpy,
and on the card also sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` where it is
unset, ``torch.use_deterministic_algorithms(True)`` and
``torch.backends.cudnn.benchmark = False``, each logged; the kernel gate's
races are left as they are, as JAX's flag leaves its gate.

``--data-parallel D`` and ``--model-parallel M`` (JAX there lines 51-54,
214-217, 272-281, 323-329, 560-563) run the commands over ``D x M`` ranks
that ``torchrun`` starts, one process each (parallel/): ``--batch-size``
is the global batch, of which each rank keeps its data index's rows;
calibration goes through ``calibrate_sharded``, the evaluation through
``evaluate_sharded``, QAT through ``shard_qat_state``, so every reduction
over the batch is global, and ``--model-parallel`` shards the weights by
JAX's weight-gather rule.  Every rank reads the whole global batch from
the loader, as one process does.  Rank 0 alone prints the metrics line
and writes checkpoints and metrics files.  ``D x M`` other than the
world, a batch ``D`` does not divide and a checkpoint of tensor-parallel
QAT are usage errors; with both at 1 nothing changes.

    torchrun --nproc-per-node 2 -m fp8_quantization_tpu_torch.cli.image_net \\
        validate-quantized --engine fused --per-channel --fp8-set-maxval \\
        --batch-size 128 --data-parallel 2

The ``fused`` engine's kernels sit behind the kernel gate
(ops/kernels/autotune.py).  As in JAX there is no flag: the mode is
``FP8TPU_PALLAS_AUTOTUNE`` (``auto`` by default: each kernel is raced
against its composed route on the card the first time a shape is seen,
and kept if it wins by 25%; ``always``; ``never``), and the verdicts are
logged at INFO after the evaluation.

    python -m fp8_quantization_tpu_torch.cli.image_net validate-quantized \\
        --device cpu --engine fused --per-channel --fp8-set-maxval \\
        --num-est-batches 1 --max-eval-batches 1 --batch-size 4
    python -m fp8_quantization_tpu_torch.cli.image_net validate-quantized \\
        --device cpu --engine fused --qmethod symmetric_uniform \\
        --qmethod-act asymmetric_uniform --per-channel --quantize-input \\
        --int8-mxu --num-est-batches 1 --max-eval-batches 1 --batch-size 4
    python -m fp8_quantization_tpu_torch.cli.image_net validate-quantized \\
        --device cpu --architecture mobilenet_v2_quantized --engine fused \\
        --bn-mode folded --per-channel --fp8-set-maxval \\
        --num-est-batches 1 --max-eval-batches 1 --batch-size 2
    python -m fp8_quantization_tpu_torch.cli.image_net validate-quantized \\
        --device cpu --architecture vit_small_quantized --engine fused \\
        --per-channel --fp8-set-maxval --num-est-batches 1 \\
        --max-eval-batches 1 --batch-size 2
    python -m fp8_quantization_tpu_torch.cli.image_net validate-quantized \\
        --device cpu --engine fused --per-channel --fp8-set-maxval \\
        --num-est-batches 1 --max-eval-batches 1 --batch-size 4 \\
        --save-checkpoint-dir /tmp/ck
    python -m fp8_quantization_tpu_torch.cli.image_net validate-quantized \\
        --device cpu --engine fused --per-channel --fp8-set-maxval \\
        --max-eval-batches 1 --batch-size 4 --load-type quantized \\
        --load-checkpoint-dir /tmp/ck
    python -m fp8_quantization_tpu_torch.cli.image_net validate-quantized \\
        --device cpu --engine fused --per-channel --fp8-set-maxval \\
        --weight-quant-method MSE --act-quant-method MSE \\
        --format-search-passes 1 --num-est-batches 1 --max-eval-batches 1 \\
        --batch-size 1
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from itertools import islice

log = logging.getLogger("image_net")


def _bool_flag(p: argparse.ArgumentParser, name: str, default: bool, help_=""):
    p.add_argument(f"--{name}", dest=name.replace("-", "_"),
                   action=argparse.BooleanOptionalAction, default=default,
                   help=help_)


def _quant_options(p: argparse.ArgumentParser) -> None:
    """The flags both commands share (JAX ``_quant_options``)."""
    p.add_argument("--images-dir", default=None,
                   help="ImageNet root with val/ (and train/ for "
                        "train-quantized); synthetic data when omitted")
    p.add_argument("--architecture", default="resnet18_quantized",
                   choices=["mobilenet_v2_quantized", "resnet18_quantized",
                            "resnet50_quantized", "vit_small_quantized"])
    p.add_argument("--model-dir", default=None,
                   help="torchvision ResNet, tonylins MobileNetV2 or timm "
                        "ViT-S/16 checkpoint (.pth/.tar); random weights "
                        "from --seed when omitted")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--interpolation", default="bilinear",
                   choices=["nearest", "bilinear", "bicubic", "lanczos", "box",
                            "hamming"])
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--deterministic", dest="deterministic",
                   action="store_true", default=False,
                   help="seed Python's random, numpy and torch from --seed; "
                        "on the card also deterministic algorithms, no cuDNN "
                        "benchmark and CUBLAS_WORKSPACE_CONFIG=:4096:8 where "
                        "unset")
    p.add_argument("--nondeterministic", dest="deterministic",
                   action="store_false", help="the default")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--data-parallel", type=int, default=1,
                   help="mesh 'data' axis size (ranks; launch them with "
                        "torchrun); --batch-size is the global batch")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="mesh 'model' axis size (weight-gather tensor "
                        "parallelism)")
    p.add_argument("--qmethod", default="fp_quantizer",
                   choices=["symmetric_uniform", "asymmetric_uniform",
                            "fp_quantizer"])
    p.add_argument("--qmethod-act", default=None)
    p.add_argument("--n-bits", type=int, default=8)
    p.add_argument("--n-bits-act", type=int, default=None)
    _bool_flag(p, "per-channel", False)
    p.add_argument("--percentile", type=float, default=None)
    p.add_argument("--weight-quant-method", default="current_minmax",
                   choices=["current_minmax", "allminmax", "running_minmax",
                            "MSE", "line_search"])
    p.add_argument("--act-quant-method", default="allminmax",
                   choices=["current_minmax", "allminmax", "running_minmax",
                            "MSE", "line_search"])
    p.add_argument("--act-momentum", type=float, default=None)
    p.add_argument("--num-candidates", type=int, default=None,
                   help="MSE grid size (111 when omitted)")
    p.add_argument("--act-num-candidates", type=int, default=None,
                   help="act-quant MSE grid size; falls back to "
                        "--num-candidates")
    p.add_argument("--quant-setup", default="all",
                   choices=["all", "FP_logits", "fc4", "fc4_dw8",
                            "dw_bf16_acts", "LSQ", "LSQ_paper"])
    _bool_flag(p, "weight-quant", True)
    _bool_flag(p, "act-quant", True)
    p.add_argument("--num-est-batches", type=int, default=1)
    _bool_flag(p, "quantize-input", False)
    p.add_argument("--fp8-maxval", type=float, default=None)
    p.add_argument("--fp8-mantissa-bits", type=int, default=4)
    _bool_flag(p, "fp8-set-maxval", False)
    _bool_flag(p, "fp8-learn-maxval", False, "QAT: maxval learns")
    _bool_flag(p, "fp8-learn-mantissa-bits", False,
               "QAT: mantissa_bits learns")
    _bool_flag(p, "fp8-mse-include-mantissa-bits", True,
               "the MSE search also votes each quantizer's mantissa bits")
    _bool_flag(p, "fp8-allow-unsigned", False)
    p.add_argument("--grad-estimator", default="ste",
                   choices=["ste", "stoch_round", "ewgs", "stacked_sigmoid"],
                   help="QAT: the rounding's gradient estimator")
    p.add_argument("--engine", default="parity",
                   choices=["parity", "bf16", "fused"],
                   help="parity=fp32 reference semantics, bf16=normalized-grid "
                        "products, fused=hand-written CUDA kernels")
    p.add_argument("--bn-mode", default="fp32_after",
                   choices=["fp32_after", "folded"],
                   help="BN after the quantized conv, or folded into the "
                        "weights before they are quantized")
    _bool_flag(p, "int8-mxu", False,
               "symmetric weights x asymmetric input quant: the s8 x s8 -> "
               "s32 datapath (with --quantize-input)")
    _bool_flag(p, "deploy-cast-quant", False,
               "fixed-mode FP8 fake-quant as one saturating IEEE f8 cast "
               "(bit-exact; ops/fp8.fp8_quantize_cast)")
    _bool_flag(p, "conv-out-bf16", False,
               "composed convs/linears whose output is re-quantized at once "
               "store it in bf16")
    _bool_flag(p, "deploy-act-f8", False,
               "store factored activations as the IEEE 1-byte array (below "
               "the smallest normal on the IEEE subnormal grid)")
    _bool_flag(p, "bake-weights", True,
               "bake the quantized weights before evaluating (default on)")
    p.add_argument("--max-eval-batches", type=int, default=None)
    _bool_flag(p, "stem-s2d", False,
               "ResNet only: run the 7x7/2 stem as the exact space-to-depth "
               "4x4/1 conv (ops/s2d.py)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="image_net")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("validate-quantized",
                       help="PTQ: calibrate ranges, freeze, bake, evaluate")
    _quant_options(p)
    p.add_argument("--load-type", default="fp32", choices=["fp32", "quantized"],
                   help="fp32: calibrate from scratch; quantized: restore a "
                        "saved calibrated state and skip calibration")
    p.add_argument("--load-checkpoint-dir", default=None,
                   help="checkpoint directory for --load-type quantized")
    p.add_argument("--save-checkpoint-dir", default=None,
                   help="save the calibrated state after calibration")
    _bool_flag(p, "reestimate-bn-stats", False,
               "re-estimate BN statistics on 2% of the calibration batches "
               "after calibrating")
    p.add_argument("--format-search-passes", type=int, default=0,
                   help="coordinate-descent sweeps over the FP8 quantizers' "
                        "mantissa bits minimizing the logits' error against "
                        "float32 (calibration/format_search.py)")

    t = sub.add_parser("train-quantized",
                       help="QAT: calibrate, fine-tune weights and ranges, "
                            "then bake, prepare and evaluate")
    _quant_options(t)
    t.add_argument("--optimizer", default="SGD")
    t.add_argument("--learning-rate", type=float, default=1e-3)
    t.add_argument("--momentum", type=float, default=0.9)
    t.add_argument("--weight-decay", type=float, default=0.0)
    t.add_argument("--learning-rate-schedule", default=None,
                   help="e.g. multistep:10:20 or cosine:0.01")
    t.add_argument("--max-epochs", type=int, default=1)
    _bool_flag(t, "sep-quant-optimizer", False,
               "train the ranges with --quant-optimizer")
    t.add_argument("--quant-optimizer", default="Adam")
    t.add_argument("--quant-learning-rate", type=float, default=1e-5)
    t.add_argument("--oscillations-dampen-weight", type=float, default=0.0,
                   help="oscillation dampening strength (0 = off)")
    t.add_argument("--oscillations-dampen-weight-final", type=float,
                   default=None)
    t.add_argument("--oscillations-dampen-anneal-start", type=float,
                   default=0.25)
    t.add_argument("--oscillations-freeze-threshold", type=float, default=0.0,
                   help="freeze weights whose oscillation frequency EMA "
                        "exceeds this (0 = off)")
    t.add_argument("--oscillations-freeze-threshold-final", type=float,
                   default=None)
    t.add_argument("--oscillations-freeze-anneal-start", type=float,
                   default=0.25)
    t.add_argument("--oscillations-freeze-ema-momentum", type=float,
                   default=0.99)
    t.add_argument("--learn-ranges", dest="learn_ranges",
                   action="store_true", default=True,
                   help="learn the ranges through the gradient estimator "
                        "(mode 'learn', the default)")
    t.add_argument("--estimate-ranges-train", dest="learn_ranges",
                   action="store_false",
                   help="re-estimate the ranges on every training batch "
                        "(mode 'calibrate_train')")
    _bool_flag(t, "reestimate-bn-stats", True,
               "re-estimate BN statistics on the training batches before "
               "each evaluation")
    t.add_argument("--reestimate-bn-batches", type=int, default=50,
                   help="batches of the BN re-estimation (JAX: 50)")
    _bool_flag(t, "grad-scaling", False, "LSQ gradient scaling (uniform)")
    t.add_argument("--save-checkpoint-dir", default=None,
                   help="save the QAT state after each epoch (step = epoch)")
    t.add_argument("--tb-logging-dir", default=None,
                   help="metrics JSONL directory")
    t.add_argument("--max-train-batches", type=int, default=None,
                   help="cap the batches of each epoch")
    parser.commands = {"validate-quantized": p, "train-quantized": t}
    return parser


def usage_error(command: str, message: str):
    """Exit with ``command``'s usage and ``message`` (status 2), as JAX's
    ``click.UsageError`` does."""
    build_parser().commands[command].error(message)


def seed_run(args) -> None:
    """The seeds of every run (numpy and torch from ``--seed``) and, under
    ``--deterministic``, Python's ``random`` too and on the card the
    deterministic settings, each logged (JAX ``_setup``)."""
    import random

    import numpy as np
    import torch

    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    if not args.deterministic:
        return
    random.seed(args.seed)
    log.info("deterministic run: python/numpy/torch RNGs seeded with %d",
             args.seed)
    if args.device != "cuda":
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    log.info("deterministic run: CUBLAS_WORKSPACE_CONFIG=%s",
             os.environ["CUBLAS_WORKSPACE_CONFIG"])
    torch.use_deterministic_algorithms(True)
    log.info("deterministic run: torch.use_deterministic_algorithms(True)")
    torch.backends.cudnn.benchmark = False
    log.info("deterministic run: torch.backends.cudnn.benchmark = False")


def build_model(args):
    """The quantized model the flags describe, on ``args.device``, with the
    checkpoint's (or ``--seed``'s random) weights loaded; in eval mode and
    not yet calibrated."""
    from fp8_quantization_tpu_torch.device import resolve_device
    from fp8_quantization_tpu_torch.models import convert
    from fp8_quantization_tpu_torch.models.mobilenet_v2 import (
        mobilenetv2_quantized)
    from fp8_quantization_tpu_torch.models.resnet import QUANT_ARCHITECTURES
    from fp8_quantization_tpu_torch.models.vit import vit_small_quantized
    from fp8_quantization_tpu_torch.nn.config import make_layer_config

    config = make_layer_config(
        qmethod=args.qmethod, act_qmethod=args.qmethod_act,
        n_bits=args.n_bits, n_bits_act=args.n_bits_act,
        per_channel_weights=args.per_channel,
        weight_range_method=args.weight_quant_method,
        act_range_method=args.act_quant_method, percentile=args.percentile,
        act_momentum=args.act_momentum, num_candidates=args.num_candidates,
        act_num_candidates=args.act_num_candidates, fp8_maxval=args.fp8_maxval,
        fp8_mantissa_bits=args.fp8_mantissa_bits,
        fp8_set_maxval=args.fp8_set_maxval,
        fp8_learn_maxval=args.fp8_learn_maxval,
        fp8_learn_mantissa_bits=args.fp8_learn_mantissa_bits,
        fp8_mse_include_mantissa_bits=args.fp8_mse_include_mantissa_bits,
        fp8_allow_unsigned=args.fp8_allow_unsigned,
        grad_scaling=getattr(args, "grad_scaling", False),
        grad_estimator=args.grad_estimator,
        quantize_input=args.quantize_input, int8_mxu=args.int8_mxu,
        bn_mode=args.bn_mode, engine=args.engine,
        deploy_cast_quant=args.deploy_cast_quant,
        conv_out_bf16=args.conv_out_bf16, deploy_act_f8=args.deploy_act_f8)
    arch, device = args.architecture, resolve_device(args.device)
    checkpoint = (convert.load_torch_state_dict(args.model_dir)
                  if args.model_dir else None)
    if arch == "mobilenet_v2_quantized":
        model = mobilenetv2_quantized(config, quant_setup=args.quant_setup,
                                      device=device)
        convert.load_tonylins_mobilenet_v2(
            model, checkpoint or convert.random_mobilenet_v2_state_dict(
                args.seed))
        return model.eval()
    if arch == "vit_small_quantized":
        model = vit_small_quantized(config, quant_setup=args.quant_setup,
                                    device=device)
        convert.load_timm_vit(
            model, checkpoint or convert.random_vit_state_dict(args.seed))
        return model.eval()
    extra = {"stem_s2d": True} if args.stem_s2d else {}   # as the JAX CLI
    model = QUANT_ARCHITECTURES[arch](config, quant_setup=args.quant_setup,
                                      device=device, **extra)
    convert.load_torchvision_resnet(
        model, checkpoint or convert.random_resnet_state_dict(
            args.seed, model.stage_sizes, "50" in arch))
    return model.eval()


def setup_parallel(args, command: str):
    """The mesh of ``--data-parallel`` x ``--model-parallel`` (JAX
    ``_setup``), None for one process.  Joins the ranks
    (parallel/multihost.initialize, from torchrun's environment); a mesh
    that is not the world, a batch that ``--data-parallel`` does not
    divide and a checkpoint of tensor-parallel QAT are usage errors.  On
    the card rank 0 alone builds the kernels while the others wait."""
    from fp8_quantization_tpu_torch.parallel import initialize, make_mesh
    from fp8_quantization_tpu_torch.parallel.multihost import (
        barrier, process_index)
    data, model = args.data_parallel, args.model_parallel
    if data < 1 or model < 1:
        usage_error(command, "--data-parallel and --model-parallel must be >= 1")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if data * model != world:
        usage_error(command, f"--data-parallel {data} x --model-parallel "
                             f"{model} != {world} ranks (launch with torchrun "
                             f"--nproc-per-node {data * model})")
    if args.batch_size % data:
        usage_error(command, f"--batch-size {args.batch_size} (the global "
                             f"batch) does not split over --data-parallel {data}")
    if (command == "train-quantized" and model > 1
            and args.save_checkpoint_dir):
        usage_error(command, "checkpoints of a tensor-parallel QAT state "
                             "(its optimizer state is sharded) are not ported "
                             "yet; train with --model-parallel 1 to save one")
    if world == 1:
        return None
    initialize(device=args.device)
    if args.device == "cuda" and args.engine == "fused":
        from fp8_quantization_tpu_torch.ops.kernels import build
        if process_index() == 0:
            build.build_all()
        barrier()
    return make_mesh(data=data, model=model)


def bake_for_eval(model, quant_w: bool, bake: bool) -> bool:
    """Bake a calibrated model as ``--bake-weights`` asks; returns the
    ``quant_w`` to evaluate with.  The int8 datapath bakes its int8 grid and
    keeps ``quant_w=True``; other configs bake the fake-quant weights and
    evaluate with ``quant_w=False``."""
    from fp8_quantization_tpu_torch.nn.bake import bake_for_inference

    if not (bake and quant_w):
        return quant_w
    quant_w = bake_for_inference(model)
    log.info("int8 weights baked: the int8 routes take the stored grid"
             if quant_w else
             "weights baked: per-step weight quantization disabled")
    return quant_w


def prepare_for_eval(model, cal_data, device, quant_w: bool,
                     quant_a: bool) -> None:
    """The prepare pass on the ``bf16`` and ``fused`` engines, on the
    device, with the flags the evaluation uses and a zero image of the
    data's size, in the geometry the model takes (it changes no value)."""
    import numpy as np
    import torch

    from fp8_quantization_tpu_torch.nn.bake import prepare_inference
    if model.config.engine in ("bf16", "fused"):
        first = next(iter(cal_data))
        shape = np.shape(first[0] if isinstance(first, (tuple, list)) else first)
        example = model.input_shape((1,) + tuple(shape[1:]))
        prepare_inference(model, torch.zeros(example, device=device),
                          quant_w=quant_w, quant_a=quant_a)
        log.info("prepared: fixed-mode constants frozen")


def format_search(model, cal_data, args, device) -> None:
    """``--format-search-passes``: the global FP8 format allocation on the
    calibration batches, logged as the JAX CLI logs it."""
    from fp8_quantization_tpu_torch.calibration.format_search import (
        network_format_search)
    _, assignment, history = network_format_search(
        model, list(islice(iter(cal_data), args.num_est_batches)),
        device=device, passes=args.format_search_passes,
        quant_w=args.weight_quant, quant_a=args.act_quant)
    log.info("global format search: network MSE %.3e -> %.3e; assignment: %s",
             history[0], history[-1], json.dumps(assignment))


def validate_quantized(args) -> dict:
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    from fp8_quantization_tpu_torch.device import resolve_device
    from fp8_quantization_tpu_torch.parallel import (
        calibrate_sharded, collectives, gather_weights, multihost)
    from fp8_quantization_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    device = resolve_device(args.device)
    if args.load_type == "quantized" and not args.load_checkpoint_dir:
        usage_error("validate-quantized",
                    "--load-type quantized requires --load-checkpoint-dir")
    mesh = setup_parallel(args, "validate-quantized")
    seed_run(args)
    model = build_model(args)
    train_data, val_data = make_dataloaders(
        args.images_dir, batch_size=args.batch_size,
        num_workers=args.num_workers, seed=args.seed,
        interpolation=args.interpolation)
    cal_data = (list(islice(iter(val_data), args.num_est_batches))
                if train_data is None else train_data)
    if args.load_type == "quantized":
        restore_checkpoint(args.load_checkpoint_dir, model)
        log.info("restored quantized state from %s (calibration skipped)",
                 args.load_checkpoint_dir)
    elif mesh is not None:
        calibrate_sharded(model, cal_data, mesh, device=device,
                          num_batches=args.num_est_batches,
                          tensor_parallel=args.model_parallel > 1,
                          quant_w=args.weight_quant, quant_a=args.act_quant)
        log.info("calibration done (%d batches, mesh %s)",
                 args.num_est_batches, mesh.shape)
    else:
        calibrate(model, cal_data, device=device,
                  num_batches=args.num_est_batches,
                  quant_w=args.weight_quant, quant_a=args.act_quant)
        log.info("calibration done (%d batches)", args.num_est_batches)
    if args.save_checkpoint_dir:
        with gather_weights(mesh, model):
            save_checkpoint(args.save_checkpoint_dir, model)
        log.info("calibrated state saved to %s", args.save_checkpoint_dir)
    with collectives.reducing_over(mesh and mesh.data_group):
        if args.reestimate_bn_stats:
            from fp8_quantization_tpu_torch.training.qat import (
                reestimate_bn_stats)
            n = max(1, int(0.02 * len(cal_data)))   # 2% of the batches, as JAX
            reestimate_bn_stats(model,
                                multihost.local_batches(cal_data, mesh),
                                num_batches=n)
            log.info("BN stats re-estimated on %d batches", n)
        if args.format_search_passes > 0:
            format_search(model, multihost.local_batches(cal_data, mesh),
                          args, device)
    return deploy_and_evaluate(model, args, cal_data, val_data, device, mesh)


def deploy_and_evaluate(model, args, cal_data, val_data, device,
                        mesh=None) -> dict:
    """Bake, prepare and evaluate ``model`` as ``validate-quantized``
    deploys it (on the engine it was built for); with a mesh, the bake on
    the gathered weights and the evaluation sharded."""
    from fp8_quantization_tpu_torch.calibration.calibrate import evaluate
    from fp8_quantization_tpu_torch.ops.kernels import autotune
    from fp8_quantization_tpu_torch.parallel import (
        evaluate_sharded, gather_weights)
    with gather_weights(mesh, model):
        quant_w = bake_for_eval(model, args.weight_quant, args.bake_weights)
    prepare_for_eval(model, cal_data, device, quant_w, args.act_quant)
    if mesh is not None:
        metrics = evaluate_sharded(model, val_data, mesh, device=device,
                                   tensor_parallel=args.model_parallel > 1,
                                   quant_w=quant_w, quant_a=args.act_quant,
                                   max_batches=args.max_eval_batches)
    else:
        metrics = evaluate(model, val_data, device=device, quant_w=quant_w,
                           quant_a=args.act_quant,
                           max_batches=args.max_eval_batches)
    log.info("kernel gate (mode %s): %s", autotune.MODE,
             json.dumps(autotune.decision_table()))
    return metrics


def _oscillation_config(args, total_steps: int):
    from fp8_quantization_tpu_torch.training.oscillation import (
        OscillationConfig)
    if not (args.oscillations_dampen_weight > 0
            or args.oscillations_freeze_threshold > 0):
        return None
    return OscillationConfig(
        dampen_weight=args.oscillations_dampen_weight,
        dampen_weight_final=args.oscillations_dampen_weight_final,
        dampen_anneal_start=args.oscillations_dampen_anneal_start,
        freeze_threshold=args.oscillations_freeze_threshold,
        freeze_threshold_final=args.oscillations_freeze_threshold_final,
        freeze_anneal_start=args.oscillations_freeze_anneal_start,
        freeze_ema_momentum=args.oscillations_freeze_ema_momentum,
        total_steps=total_steps)


def train_quantized(args) -> dict:
    """QAT (JAX ``train_quantized``, cli/image_net.py:479-594): calibrate
    on the training batches, then per epoch train, and evaluate a copy of
    the trained model re-estimated (``--reestimate-bn-stats``), baked,
    prepared and run on ``--engine`` as ``validate-quantized`` deploys it
    (JAX evaluates unbaked).  Returns the last epoch's metrics."""
    import copy

    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    from fp8_quantization_tpu_torch.device import resolve_device
    from fp8_quantization_tpu_torch.training.qat import (
        init_qat_state, make_optimizer, make_train_step, reestimate_bn_stats,
        train_epoch)
    from fp8_quantization_tpu_torch.parallel import (
        calibrate_sharded, collectives, gather_weights, multihost,
        shard_qat_state)
    from fp8_quantization_tpu_torch.utils.checkpoint import save_checkpoint
    from fp8_quantization_tpu_torch.utils.metrics import MetricsLogger

    device = resolve_device(args.device)
    mesh = setup_parallel(args, "train-quantized")
    seed_run(args)
    model = build_model(args)
    train_data, val_data = make_dataloaders(
        args.images_dir, batch_size=args.batch_size,
        num_workers=args.num_workers, seed=args.seed,
        interpolation=args.interpolation)
    if train_data is None:
        raise SystemExit(f"--images-dir {args.images_dir} has no train/ "
                         "split; train-quantized needs one "
                         "(validate-quantized works val-only)")
    if mesh is not None:
        calibrate_sharded(model, train_data, mesh, device=device,
                          num_batches=args.num_est_batches)
    else:
        calibrate(model, train_data, device=device,
                  num_batches=args.num_est_batches)
    log.info("calibration done (%d batches)", args.num_est_batches)

    steps_per_epoch = len(train_data) if hasattr(train_data, "__len__") else 1000
    model_tx = make_optimizer(args.optimizer, args.learning_rate,
                              momentum=args.momentum,
                              weight_decay=args.weight_decay,
                              scheduler=args.learning_rate_schedule,
                              max_steps=steps_per_epoch * args.max_epochs,
                              steps_per_epoch=steps_per_epoch)
    quant_tx = (make_optimizer(args.quant_optimizer, args.quant_learning_rate)
                if args.sep_quant_optimizer else None)
    state = init_qat_state(
        model, model.config, model_tx, quant_tx,
        oscillation=_oscillation_config(args, steps_per_epoch * args.max_epochs))
    if mesh is not None:
        state = shard_qat_state(mesh, state,
                                tensor_parallel=args.model_parallel > 1)
    mode = "learn" if args.learn_ranges else "calibrate_train"
    step_fn = make_train_step(state, mode=mode)

    def batches():
        return multihost.local_batches(train_data, mesh,
                                       args.max_train_batches or None)

    val_metrics = None
    with MetricsLogger(args.tb_logging_dir, run_name=args.architecture) as mlog:
        for epoch in range(args.max_epochs):
            state, metrics = train_epoch(state, batches(), mode=mode,
                                         step_fn=step_fn)
            mlog.log(epoch, metrics, prefix="train/")
            with gather_weights(mesh, model):
                deployed = copy.deepcopy(model)
            if args.reestimate_bn_stats:
                with collectives.reducing_over(mesh and mesh.data_group):
                    reestimate_bn_stats(deployed, batches(),
                                        num_batches=args.reestimate_bn_batches)
            val_metrics = deploy_and_evaluate(deployed, args, train_data,
                                              val_data, device, mesh)
            mlog.log(epoch, val_metrics, prefix="val/")
            if args.save_checkpoint_dir:
                save_checkpoint(args.save_checkpoint_dir, state, step=epoch)
                log.info("QAT state saved to %s (step %d)",
                         args.save_checkpoint_dir, epoch)
    return val_metrics


def main(argv=None) -> None:
    from fp8_quantization_tpu_torch.parallel import multihost
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "INFO"))
    args = build_parser().parse_args(argv)
    if args.command == "validate-quantized":
        metrics = validate_quantized(args)
    else:
        metrics = train_quantized(args)
    if multihost.process_index() == 0:    # every rank holds the global metrics
        print(json.dumps(metrics))
    multihost.shutdown()


if __name__ == "__main__":
    main()

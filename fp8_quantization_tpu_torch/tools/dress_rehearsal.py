"""Full-scale dress rehearsal of the real-data PTQ path.

The port's counterpart of ``tools/dress_rehearsal.py``.  One command:

    python -m fp8_quantization_tpu_torch.tools.dress_rehearsal \\
        [--workdir DIR] [--images 2000] \\
        [--archs resnet18,mobilenet_v2,vit_small] [--device cuda|cpu]

It (a) writes random torch checkpoints in the on-disk layouts the real
weights ship in (torchvision ResNet-18, tonylins MobileNetV2, timm
ViT-S/16) at full width and 1000 classes (models/convert.py's
``random_*_state_dict``), (b) writes a 1000-class ImageFolder val tree of
synthetic JPEGs (PIL), and (c) runs ``validate-quantized`` of the port's
CLI in a process of its own for each architecture with the BASELINE
configs #2-#4 flag set:

    conversion (--model-dir) -> calibration -> fixed-range evaluation

The top-1 it prints is chance (the weights are random); what passes is the
path: .pth parsing, layout conversion, JPEG decode at 1000 classes,
calibration and the batched evaluation on the device.  With real assets
(``--images-dir``, ``--model-dirs``) the same command lines give the
BASELINE numbers; they are printed at the end.

The JPEG leg needs PIL.  Where PIL is missing and no ``--images-dir`` is
given the rehearsal stops with a message (exit status 1); it does not
switch to synthetic batches, which would skip the decode it rehearses.

Architectures are named by their short names (``resnet18``,
``mobilenet_v2``, ``vit_small``, ``resnet50``: those of ``--archs`` and of
the preflight scan) or the CLI's (``resnet18_quantized``, ...);
``architecture`` maps both to the CLI's in one place.  JAX's rehearsal
keys its flags by the CLI's names alone, so a real checkpoint passed by
its short name (as ``preflight`` passes the ones it detects) raises
``KeyError`` there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parent.parent.parent

ARCHITECTURES = {"resnet18": "resnet18_quantized",
                 "resnet50": "resnet50_quantized",
                 "mobilenet_v2": "mobilenet_v2_quantized",
                 "vit_small": "vit_small_quantized"}

# BASELINE.md configs #2-#4: FP8 PTQ (per-channel weights, set-maxval),
# the paper's W8A8 evaluation recipe
_FP8_PTQ = ["--qmethod", "fp_quantizer", "--per-channel", "--fp8-set-maxval",
            "--weight-quant-method", "current_minmax",
            "--act-quant-method", "allminmax", "--fp8-mantissa-bits", "4"]
BASELINE_FLAGS = {arch: _FP8_PTQ for arch in ARCHITECTURES.values()}


def architecture(name: str) -> str:
    """The CLI's architecture for a short or a CLI name."""
    if name in ARCHITECTURES.values():
        return name
    if name not in ARCHITECTURES:
        raise ValueError(f"unknown architecture {name!r}; one of "
                         f"{sorted(ARCHITECTURES)} or their *_quantized names")
    return ARCHITECTURES[name]


def _state_dict(arch: str, seed: int) -> dict:
    import numpy as np
    import torch

    from fp8_quantization_tpu_torch.models import convert
    sd = {"resnet18_quantized": lambda: convert.random_resnet_state_dict(seed),
          "resnet50_quantized": lambda: convert.random_resnet_state_dict(
              seed, (3, 4, 6, 3), bottleneck=True),
          "mobilenet_v2_quantized": lambda: convert.random_mobilenet_v2_state_dict(seed),
          "vit_small_quantized": lambda: convert.random_vit_state_dict(seed)}[arch]()
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def make_checkpoints(workdir: Path, archs, seed: int = 0) -> dict:
    """{CLI architecture: path}: random state dicts of ``archs`` (short or
    CLI names) in the checkpoints' layouts, written by ``torch.save``."""
    import torch

    paths = {}
    for name in archs:
        arch = architecture(name)
        path = Path(workdir) / f"{arch.removesuffix('_quantized')}_random.pth"
        torch.save(_state_dict(arch, seed), path)
        paths[arch] = path
    return paths


def make_imagefolder(root: Path, num_images: int, num_classes: int = 1000,
                     size: int = 256) -> Path:
    """A ``num_classes``-class ImageFolder val tree of ``num_images``
    synthetic JPEGs under ``root/val`` (kept where it is already there)."""
    import numpy as np
    from PIL import Image

    val = Path(root) / "val"
    if val.exists() and sum(1 for _ in val.rglob("*.jpg")) >= num_images:
        return Path(root)
    rng = np.random.RandomState(0)
    t0 = time.time()
    for i in range(num_images):
        d = val / f"n{i % num_classes:08d}"
        d.mkdir(parents=True, exist_ok=True)
        # structured noise, so that calibration sees non-degenerate statistics
        base = rng.normal(128, 8, (8, 8, 3))
        img = np.clip(np.kron(base, np.ones((size // 8, size // 8, 1)))
                      + rng.normal(0, 40, (size, size, 3)), 0, 255)
        Image.fromarray(img.astype("uint8")).save(d / f"img_{i:06d}.jpg",
                                                  quality=85)
    print(f"wrote {num_images} JPEGs across {num_classes} classes "
          f"in {time.time() - t0:.1f}s", flush=True)
    return Path(root)


def _pil_available() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def cli_env() -> dict:
    """The environment of a subprocess that runs ``python -m
    fp8_quantization_tpu_torch...`` from wherever the caller is."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(PACKAGE_ROOT)] + ([path] if path else [])))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dress_rehearsal")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "fp8tpu_rehearsal"))
    ap.add_argument("--images", type=int, default=2000,
                    help="synthetic val JPEGs (50000 = full ImageNet val)")
    ap.add_argument("--archs", default="resnet18,mobilenet_v2,vit_small")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="forwarded to the CLI (its default: cuda)")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--max-eval-batches", type=int, default=None)
    ap.add_argument("--engine", default="bf16")
    ap.add_argument("--images-dir", default=None,
                    help="real ImageNet root (train/ + val/): skip the "
                         "synthetic JPEG tree and evaluate on it")
    ap.add_argument("--model-dirs", default=None,
                    help="comma-separated arch=path.pth real checkpoints: "
                         "skip the synthetic checkpoints of those archs")
    return ap


def main(argv=None) -> dict:
    """The rehearsal; returns {architecture: the CLI's metrics and its wall
    seconds}."""
    args = build_parser().parse_args(argv)
    if args.images_dir is None and not _pil_available():
        raise SystemExit(
            "dress_rehearsal: the synthetic JPEG tree needs PIL (Pillow), "
            "which is not installed; install it, or pass --images-dir with "
            "an ImageFolder tree to evaluate on")
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    archs = [architecture(a) for a in args.archs.split(",")]
    real = ({architecture(a): Path(p) for a, p in
             (kv.split("=", 1) for kv in args.model_dirs.split(","))}
            if args.model_dirs else {})
    ckpts = make_checkpoints(workdir, [a for a in archs if a not in real])
    ckpts.update(real)
    data_root = (Path(args.images_dir) if args.images_dir
                 else make_imagefolder(workdir / "imagenet", args.images))

    results, cmds = {}, {}
    for arch, ckpt in ckpts.items():
        cmd = [sys.executable, "-m", "fp8_quantization_tpu_torch.cli.image_net",
               "validate-quantized", "--architecture", arch,
               "--model-dir", str(ckpt), "--images-dir", str(data_root),
               "--batch-size", str(args.batch_size), "--engine", args.engine,
               *BASELINE_FLAGS[arch]]
        if args.device:
            cmd += ["--device", args.device]
        if args.max_eval_batches:
            cmd += ["--max-eval-batches", str(args.max_eval_batches)]
        cmds[arch] = " ".join(cmd[1:])
        print(f"\n=== {arch} ===\n{' '.join(cmd)}", flush=True)
        t0 = time.time()
        out = subprocess.run(cmd, capture_output=True, text=True, env=cli_env())
        wall = time.time() - t0
        last = [line for line in out.stdout.strip().splitlines()
                if line.startswith("{")]
        if out.returncode != 0 or not last:
            print(out.stdout[-3000:])
            print(out.stderr[-3000:])
            raise SystemExit(f"{arch} FAILED (rc={out.returncode})")
        results[arch] = {**json.loads(last[-1]), "wall_s": round(wall, 1)}
        print(json.dumps(results[arch]), flush=True)

    print("\n=== rehearsal summary (random weights -> chance-level top-1; "
          "the PATH is what passed) ===")
    print(json.dumps(results, indent=2))
    print("\nTo produce the BASELINE.md numbers with real assets, re-run with "
          "--model-dir <real .pth> and --images-dir <real ImageNet root>:")
    for c in cmds.values():
        print(f"  {c}")
    return results


if __name__ == "__main__":
    main()

"""The comparison that decides ``correct``: the logits that the timed window
produced, on a sample of its batches drawn from the seed, against the plain
reference (``benchmark/reference/<architecture>.py``) run on the same images
with the same weights, after it has calibrated on the same calibration
batches.

Under FP8 activation quantization the logits are chaotic: a last-bit
change anywhere flips a few values onto the next grid step, each flip
moves the next layer's sums across more steps, and by the last blocks the
logits have moved by a good part of their quantization error.  A sound
program differs from the reference in the rounding of its sums, so it lies
at that chaotic floor, never at zero.  The floor is measured with the
reference itself: the same reference with its products summed in float64
(``wide``) against it.  The numbers, over all rows (images) of the sampled
batches, in units of the reference's spread (the rms of its logits about
their per-class means over the rows):

* ``gap``: the rms of program minus reference;
* ``floor``: the rms of the wide reference minus the reference;
* ``excess``: ``gap^2 / floor^2 - 1``, the mean square by which the program
  lies farther from the reference than rounding alone carries, as a share
  of the floor's;
* ``row_excess``: the same of the row whose difference is largest, its mean
  square over the floor's, less 1.

A cell's file names the numbers it compares and the limit of each
(``check.limits``): ``correct`` holds where every one is at most its
limit.  The references run in blocks of ``ROWS`` images.
"""

from __future__ import annotations

import importlib

import torch

ROWS = 64


def reference_model(config: dict, sd: dict, mbits: int,
                    datapath: str | None = None, wide: bool = False):
    """The configuration's plain reference over the state dict ``sd``, with
    ``mbits`` mantissa bits, on the configuration's datapath unless
    ``datapath`` names another (the control's)."""
    ref = importlib.import_module(f"benchmark.reference.{config['architecture']}")
    return ref.build(config["model"], sd, mbits, datapath or config["datapath"],
                     wide)


def logits(model, cal: list, x: torch.Tensor) -> torch.Tensor:
    """``model``'s logits over ``x`` after it has calibrated on the batches
    ``cal``."""
    for batch in cal:
        model.calibrate(batch)
    return torch.cat([model(x[i:i + ROWS]) for i in range(0, x.shape[0], ROWS)])


def numbers(program: torch.Tensor, ref: torch.Tensor,
            wide: torch.Tensor) -> dict:
    """The numbers of float32 logits (rows, classes), all on one device."""
    spread = (ref - ref.mean(dim=0)).pow(2).mean().sqrt()
    d = program - ref
    gap = d.pow(2).mean().sqrt() / spread
    # a floor of exactly 0 (no rounding reaches the logits) counts as 1e-6
    floor = torch.clamp((wide - ref).pow(2).mean().sqrt() / spread, min=1e-6)
    row = d.pow(2).mean(dim=1).max() / (spread * spread)
    return {"gap": float(gap), "floor": float(floor),
            "excess": float(gap * gap / (floor * floor) - 1.0),
            "row_excess": float(row / (floor * floor) - 1.0)}


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the numbers that the cell
    compares."""
    shown = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    return all(values[k] <= lim for k, lim in limits.items()), shown

"""Calibration and evaluation loops.

Mirrors ``fp8_quantization_tpu/calibration/calibrate.py`` (``calibrate``,
``evaluate``; the per-batch sufficient statistics of its ``make_eval_step``
give top-1 / top-5 / loss).  Ranges update during the forward, so deeper
layers calibrate on activations produced with the shallower layers'
just-updated ranges, as in the JAX package.  Batches are numpy or torch
(x NHWC, y int labels) and are moved to ``device``.
"""

from __future__ import annotations

import logging
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

log = logging.getLogger(__name__)


def _to(a, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
    return t.to(device=device, dtype=dtype)


@torch.no_grad()
def calibrate(model, batches: Iterable, *, device, num_batches: Optional[int] = None,
              quant_w: bool = True, quant_a: bool = True):
    """Run <= num_batches through ``model`` in 'calibrate' mode."""
    for i, batch in enumerate(batches):
        if num_batches is not None and i >= num_batches:
            break
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        model(_to(x, device, torch.float32), mode="calibrate",
              quant_w=quant_w, quant_a=quant_a)
        log.info("calibration batch %d done", i)
    return model


def batch_stats(logits: torch.Tensor, y: torch.Tensor) -> dict:
    """Sums of loss, top-1 and top-5 hits over one batch."""
    logits = logits.to(torch.float32)
    nll = F.cross_entropy(logits, y, reduction="sum")
    top1 = (logits.argmax(dim=-1) == y).sum()
    top5 = (logits.topk(5, dim=-1).indices == y[:, None]).any(dim=-1).sum()
    return {"loss_sum": float(nll), "top1_sum": int(top1),
            "top5_sum": int(top5), "count": int(y.shape[0])}


@torch.no_grad()
def evaluate(model, batches: Iterable, *, device, quant_w: bool = True,
             quant_a: bool = True, mode: str = "fixed",
             max_batches: Optional[int] = None) -> dict:
    """Top-1 / top-5 / loss over a dataset."""
    totals = None
    for i, (x, y) in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        logits = model(_to(x, device, torch.float32), mode=mode,
                       quant_w=quant_w, quant_a=quant_a)
        stats = batch_stats(logits, _to(y, device, torch.long))
        totals = stats if totals is None else {k: totals[k] + v
                                               for k, v in stats.items()}
    if totals is None:
        raise ValueError("no evaluation batches")
    n = float(totals["count"])
    return {"top_1_accuracy": totals["top1_sum"] / n,
            "top_5_accuracy": totals["top5_sum"] / n,
            "loss": totals["loss_sum"] / n,
            "num_examples": int(n)}

"""Calibration and evaluation loops.

Mirrors ``fp8_quantization_tpu/calibration/calibrate.py`` (``calibrate``
with ``stop_after``, ``partial_quant_updates``, ``evaluate``; the
per-batch sufficient statistics of its ``make_eval_step`` give top-1 /
top-5 / loss).  Ranges update during the forward, so deeper layers
calibrate on activations produced with the shallower layers' just-updated
ranges, as in the JAX package.

``stop_after`` keeps each batch's updates of the quantizers up to and
including the named module and gives the later ones back their state from
before the batch.  Modules are taken in execution order, the order of the
JAX ``quant`` collection's keys: each quantizer's state is placed in a
nested dict by its module path (``layer1_0.conv1.weight_q`` ->
``["layer1_0"]["conv1"]["weight_q"]``) in the order the forward first
calls it, and ``partial_quant_updates`` walks it as JAX does.  Batches are numpy or torch
(x NHWC, y int labels) and are moved to ``device``.

Data-parallel calibration and evaluation are parallel/api.py's
``calibrate_sharded`` and ``evaluate_sharded``: each rank runs these loops
on its rows of every global batch inside a reduction scope
(parallel/collectives.py), so the estimators and the evaluation's sums
reduce over the data group.
"""

from __future__ import annotations

import logging
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fp8_quantization_tpu_torch.parallel import collectives

log = logging.getLogger(__name__)


def _to(a, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
    return t.to(device=device, dtype=dtype)


def partial_quant_updates(new: dict, old: dict, stop_after: str) -> dict:
    """Keep the updates up to and including the module named ``stop_after``
    (a key, or a '/'-joined path) in ``new``'s key order; later leaves
    keep their ``old`` values (JAX ``partial_quant_updates``)."""
    done = [False]

    def rec(n, o, path):
        out = {}
        for k, v in n.items():
            p = path + (k,)
            if done[0]:
                out[k] = o[k]
            elif isinstance(v, dict):
                out[k] = rec(v, o[k], p)
                if k == stop_after or "/".join(p) == stop_after:
                    done[0] = True
            else:
                out[k] = v
        return out

    masked = rec(new, old, ())
    if not done[0]:
        raise ValueError(f"stop_after={stop_after!r} matched no module in "
                         f"the quant collection")
    return masked


def _quant_tree(quantizers) -> dict:
    """{module path: {"q": state, "est": estimator state}} nested by the
    path's parts, in the order of ``quantizers`` ((name, module) pairs)."""
    tree: dict = {}
    for name, qz in quantizers:
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        node["q"] = {k: v.clone() for k, v in qz.state().items()}
        node["est"] = {k: v.clone() for k, v in qz.est_state().items()}
    return tree


def _node(tree: dict, name: str) -> dict:
    for part in name.split("."):
        tree = tree[part]
    return tree


@torch.no_grad()
def calibrate(model, batches: Iterable, *, device, num_batches: Optional[int] = None,
              quant_w: bool = True, quant_a: bool = True,
              stop_after: Optional[str] = None):
    """Run <= num_batches through ``model`` in 'calibrate' mode; with
    ``stop_after`` only the quantizers up to and including that module keep
    their updates (see the module docstring)."""
    from fp8_quantization_tpu_torch.nn.quantizers import Quantizer

    quantizers = [(n, m) for n, m in model.named_modules()
                  if isinstance(m, Quantizer)]
    order: list = []
    hooks = []
    if stop_after is not None:
        for name, qz in quantizers:
            hooks.append(qz.register_forward_pre_hook(
                lambda mod, args, _n=name: order.append(_n)
                if _n not in order else None))
    try:
        for i, batch in enumerate(batches):
            if num_batches is not None and i >= num_batches:
                break
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            old = _quant_tree(quantizers) if stop_after is not None else None
            model(_to(x, device, torch.float32), mode="calibrate",
                  quant_w=quant_w, quant_a=quant_a)
            if stop_after is not None:
                ranked = order + [n for n, _ in quantizers if n not in order]
                by_name = dict(quantizers)
                new = _quant_tree([(n, by_name[n]) for n in ranked])
                kept = partial_quant_updates(new, old, stop_after)
                for name, qz in quantizers:
                    node = _node(kept, name)
                    qz.load_state(node["q"], node["est"])
            log.info("calibration batch %d done", i)
    finally:
        for h in hooks:
            h.remove()
    return model


def batch_stats(logits: torch.Tensor, y: torch.Tensor) -> dict:
    """Sums of loss, top-1 and top-5 hits over one batch."""
    logits = logits.to(torch.float32)
    nll = F.cross_entropy(logits, y, reduction="sum")
    top1 = (logits.argmax(dim=-1) == y).sum()
    # fewer than five classes: all of them, as JAX's argsort(...)[:, -5:]
    k = min(5, logits.shape[-1])
    top5 = (logits.topk(k, dim=-1).indices == y[:, None]).any(dim=-1).sum()
    return {"loss_sum": float(nll), "top1_sum": int(top1),
            "top5_sum": int(top5), "count": int(y.shape[0])}


@torch.no_grad()
def evaluate(model, batches: Iterable, *, device, quant_w: bool = True,
             quant_a: bool = True, mode: str = "fixed",
             max_batches: Optional[int] = None) -> dict:
    """Top-1 / top-5 / loss over a dataset; inside a
    ``parallel.collectives.reducing_over`` scope each rank evaluates its
    rows and the sums are reduced over the data group, so every rank
    returns the global metrics."""
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
    if collectives.active():        # each rank held its rows of the batches
        keys = sorted(totals)
        sums = collectives.all_sum(torch.tensor(
            [float(totals[k]) for k in keys], dtype=torch.float64,
            device=device))
        totals = dict(zip(keys, sums.tolist()))
    n = float(totals["count"])
    return {"top_1_accuracy": totals["top1_sum"] / n,
            "top_5_accuracy": totals["top5_sum"] / n,
            "loss": totals["loss_sum"] / n,
            "num_examples": int(n)}

"""MSE line search over clipping thresholds.

Mirrors ``fp8_quantization_tpu/calibration/line_search.py``: each
candidate threshold ``t`` sets a per-tensor range ``(-t, t)`` (``(0, t)``
when the data is one-sided), the tensor is fake-quantized with it and the
squared error summed.  ``line_search_range`` searches a grid of
``num_candidates`` thresholds ``step * i``, ``i = 1 .. N``, ``step =
(absmax + range_margin) * expand_range / N``, or runs scipy's bounded
golden-section search over ``[step, N * step]`` (approximate: the error is
not unimodal in the threshold).  ``LineSearchEstimator`` accumulates the
grid's losses over batches.  The per-channel estimator of the same search
is ``calibration/estimators.py`` (kind ``line_search``).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from fp8_quantization_tpu_torch.ops import fp8 as fp8_ops
from fp8_quantization_tpu_torch.ops import uniform as uniform_ops
from fp8_quantization_tpu_torch.ops.quantizer import QMethod, QuantizerSpec


class OptMethod(str, enum.Enum):
    grid = "grid"
    golden_section = "golden_section"


def quantize_with_range(qspec: QuantizerSpec, x: torch.Tensor, neg_thr,
                        pos_thr) -> torch.Tensor:
    """``x`` fake-quantized by a per-tensor quantizer of ``qspec`` whose
    range is set to (neg_thr, pos_thr); thresholds broadcast against ``x``
    (a leading candidate axis)."""
    if qspec.is_fp8:
        maxval, sign_bits = fp8_ops.fp8_set_quant_range(
            neg_thr, pos_thr, allow_unsigned=qspec.allow_unsigned)
        return fp8_ops.quantize_to_fp8(x, maxval, float(qspec.mantissa_bits),
                                       n_bits=qspec.n_bits, sign_bits=sign_bits)
    kw = dict(scale_domain=qspec.scale_domain, eps=qspec.eps)
    if qspec.method == QMethod.symmetric_uniform:
        delta, signed = uniform_ops.symmetric_set_quant_range(
            neg_thr, pos_thr, qspec.n_bits, **kw)
        return uniform_ops.quantize_uniform_symmetric(x, delta, signed,
                                                      qspec.n_bits, **kw)
    delta, zero_float = uniform_ops.asymmetric_set_quant_range(
        neg_thr, pos_thr, qspec.n_bits, **kw)
    return uniform_ops.quantize_uniform_asymmetric(x, delta, zero_float,
                                                   qspec.n_bits, **kw)


@torch.no_grad()
def candidate_losses(qspec: QuantizerSpec, x: torch.Tensor,
                     thresholds: torch.Tensor, one_sided,
                     per_row: bool = False) -> torch.Tensor:
    """Summed squared error of ``x`` at each threshold: ``(n,)``, or ``(n,
    C)`` summed per row of a ``(C, N)`` ``x`` with ``per_row``.  One
    threshold at a time, as the JAX package's ``lax.map`` computes it."""
    x = x.to(torch.float32)
    one_sided = torch.as_tensor(one_sided, device=x.device)
    dims = -1 if per_row else tuple(range(x.ndim))
    out = []
    for t in thresholds:
        neg = torch.where(one_sided, torch.zeros_like(t), -t)
        y = quantize_with_range(qspec, x, neg, t)
        out.append(torch.sum((x - y) ** 2, dim=dims))
    return torch.stack(out)


def _search_space(x: torch.Tensor, num_candidates: int, range_margin: float,
                  expand_range: float):
    one_sided = bool(torch.amin(x) >= 0)
    data_min, data_max = float(torch.amin(x)), float(torch.amax(x))
    max_search_range = (max(abs(data_min), data_max) + range_margin) * expand_range
    return one_sided, max_search_range / num_candidates, max_search_range


def _grid(step: float, n: int, device) -> torch.Tensor:
    return (torch.tensor(step, dtype=torch.float32, device=device)
            * torch.arange(1, n + 1, dtype=torch.float32, device=device))


def line_search_range(x, qspec: QuantizerSpec, num_candidates: int = 1000,
                      range_margin: float = 0.5, expand_range: float = 10.0,
                      opt_method: OptMethod = OptMethod.grid):
    """The best symmetric (or one-sided) clipping range of ``x`` by the
    squared quantization error: ``(x_min, x_max)`` floats."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                        dtype=torch.float32)
    one_sided, step, max_search_range = _search_space(
        x, num_candidates, range_margin, expand_range)
    if OptMethod(opt_method) == OptMethod.golden_section:
        from scipy.optimize import minimize_scalar

        def loss(t):
            if t <= 0:
                return np.inf
            t32 = torch.tensor(t, dtype=torch.float32)
            neg = torch.zeros_like(t32) if one_sided else -t32
            return float(torch.sum((x - quantize_with_range(qspec, x, neg, t32)) ** 2))

        best = float(minimize_scalar(loss, bounds=(step, max_search_range),
                                     method="bounded").x)
        return (0.0 if one_sided else -best), best
    thresholds = _grid(step, num_candidates, x.device)
    losses = candidate_losses(qspec, x, thresholds, one_sided)
    best = float(thresholds[int(torch.argmin(losses))])
    return (0.0 if one_sided else -best), best


class LineSearchEstimator:
    """Accumulates the grid's candidate losses over batches; the search
    range and one-sidedness are frozen on the first batch."""

    def __init__(self, qspec: QuantizerSpec, num_candidates: int = 1000,
                 range_margin: float = 0.5, expand_range: float = 10.0):
        self.qspec = qspec
        self.num_candidates = num_candidates
        self.range_margin = range_margin
        self.expand_range = expand_range
        self.loss_array = None
        self.thresholds = None
        self.one_sided = None

    def update(self, x):
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x, dtype=torch.float32)
        if self.loss_array is None:
            self.one_sided, step, _ = _search_space(
                x, self.num_candidates, self.range_margin, self.expand_range)
            self.thresholds = _grid(step, self.num_candidates, x.device)
            self.loss_array = torch.zeros(self.num_candidates, device=x.device)
        self.loss_array = self.loss_array + candidate_losses(
            self.qspec, x, self.thresholds, self.one_sided)
        return self.current_range()

    def current_range(self):
        best = float(self.thresholds[int(torch.argmin(self.loss_array))])
        return (0.0 if self.one_sided else -best), best

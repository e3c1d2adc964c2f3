"""Range estimators as functional folds over calibration batches.

Mirrors ``fp8_quantization_tpu/calibration/estimators.py`` for
``current_minmax``, ``allminmax`` and ``running_minmax``.  The MSE search,
the line search and percentile clipping are not ported yet and raise
``NotImplementedError``.

``x_cn`` is the channel-major 2-D view ``(C, N)`` of the observed tensor
(``C = 1`` per tensor).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import torch

from fp8_quantization_tpu_torch.ops.quantizer import QuantizerSpec


class RangeEstimators(str, enum.Enum):
    current_minmax = "current_minmax"
    allminmax = "allminmax"
    running_minmax = "running_minmax"
    MSE = "MSE"
    line_search = "line_search"


_PORTED = (RangeEstimators.current_minmax, RangeEstimators.allminmax,
           RangeEstimators.running_minmax)


@dataclasses.dataclass(frozen=True)
class EstimatorSpec:
    kind: RangeEstimators = RangeEstimators.current_minmax
    percentile: Optional[float] = None
    momentum: float = 0.9                    # running_minmax only

    def __post_init__(self):
        if RangeEstimators(self.kind) not in _PORTED:
            raise NotImplementedError(
                f"range estimator {self.kind!s} is not ported yet "
                "(MSE and line search come with the search slice)")
        if self.percentile:
            raise NotImplementedError("percentile clipping is not ported yet")

    def replace(self, **kw) -> "EstimatorSpec":
        return dataclasses.replace(self, **kw)


EstState = Dict[str, torch.Tensor]


def init_state(spec: EstimatorSpec, qspec: QuantizerSpec,
               num_channels: int | None, device=None) -> EstState:
    """The estimator's carry, shapes fixed at build time."""
    if spec.kind == RangeEstimators.current_minmax:
        return {}
    shape = (num_channels,) if qspec.per_channel else ()
    return {"xmin": torch.zeros(shape, device=device),
            "xmax": torch.zeros(shape, device=device),
            "seen": torch.zeros((), dtype=torch.bool, device=device)}


def _squeeze(v: torch.Tensor, per_channel: bool) -> torch.Tensor:
    return v if per_channel else v.reshape(())


def update(spec: EstimatorSpec, qspec: QuantizerSpec, state: EstState,
           x_cn: torch.Tensor) -> Tuple[EstState, torch.Tensor, torch.Tensor]:
    """One calibration-batch step: ``(new_state, x_min, x_max)``."""
    pc = qspec.per_channel
    lo = _squeeze(torch.amin(x_cn, dim=-1), pc)
    hi = _squeeze(torch.amax(x_cn, dim=-1), pc)
    if spec.kind == RangeEstimators.current_minmax:
        return state, lo, hi
    seen = state["seen"]
    if spec.kind == RangeEstimators.allminmax:
        lo = torch.where(seen, torch.minimum(state["xmin"], lo), lo)
        hi = torch.where(seen, torch.maximum(state["xmax"], hi), hi)
    else:   # running_minmax: EMA with momentum
        m = spec.momentum
        lo = torch.where(seen, (1 - m) * lo + m * state["xmin"], lo)
        hi = torch.where(seen, (1 - m) * hi + m * state["xmax"], hi)
    new = {"xmin": lo, "xmax": hi, "seen": torch.ones_like(seen)}
    return new, lo, hi

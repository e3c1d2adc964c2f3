"""Range estimators as functional folds over calibration batches.

Mirrors ``fp8_quantization_tpu/calibration/estimators.py``:
``current_minmax`` (with percentile clipping), ``allminmax``,
``running_minmax``, the ``MSE`` grid search with its mantissa-bit sweep and
plurality vote (FP8; a symmetric grid for the uniform methods) and the
per-channel ``line_search`` (``calibration/line_search.py``).

``x_cn`` is the channel-major 2-D view ``(C, N)`` of the observed tensor
(``C = 1`` per tensor).  ``update`` returns ``(state, x_min, x_max,
quantizer_updates)``; the MSE search's updates carry the voted
``mantissa_bits``.

The MSE and line searches sweep their candidates in chunks, with the JAX
package's size rule (``chunk = max(1, min(16, 2e8 // x.numel()))``): a
chunk holds a few copies of ``x`` at most, never one per candidate.  The
values are the same whatever the chunk.  The search grid's steps are
``jnp.linspace``'s float32 points as the compiled calibration step folds
them (``search_steps``), and the percentile is ``jnp.percentile``'s
linear interpolation as that step computes it (``percentile``).  Where
XLA fuses the grid with the channels' absmax it may round a point an ulp
apart.

Data-parallel calibration (parallel/api.calibrate_sharded) opens a
``parallel.collectives.reducing_over`` scope, in which every reduction
over the observed tensor is global, as it is over JAX's sharded batch:
the min and max (one collective for both), the MSE search's absmax and
sign, and its squared-error tables, each rank's sums added and divided by
the global count before the argmin and the vote, which then run on the
same table in every rank; the line search's data range and summed
losses.  The percentile gathers the whole sample before its sort: exact,
at the cost of holding the global tensor in every rank.  Outside a scope
every path is unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Sequence, Tuple

import torch

from fp8_quantization_tpu_torch.ops import fp8 as fp8_ops
from fp8_quantization_tpu_torch.ops import uniform as uniform_ops
from fp8_quantization_tpu_torch.ops.quantizer import QuantizerSpec
from fp8_quantization_tpu_torch.parallel import collectives

# Number of maxval candidates of the MSE grid search, linspace(0.1 * absmax,
# 1.2 * absmax, 111), as in the JAX package.
MSE_NUM_CANDIDATES = 111


class RangeEstimators(str, enum.Enum):
    current_minmax = "current_minmax"
    allminmax = "allminmax"
    running_minmax = "running_minmax"
    MSE = "MSE"
    line_search = "line_search"


@dataclasses.dataclass(frozen=True)
class EstimatorSpec:
    kind: RangeEstimators = RangeEstimators.current_minmax
    percentile: Optional[float] = None       # current_minmax only
    momentum: float = 0.9                    # running_minmax only
    # MSE grid size (--num-candidates); None keeps the 111-point grid
    num_candidates: Optional[int] = None
    # line_search only
    range_margin: float = 0.5
    expand_range: float = 10.0

    @property
    def grid_size(self) -> int:
        return self.num_candidates or MSE_NUM_CANDIDATES

    @property
    def line_search_size(self) -> int:
        return self.num_candidates or 1000

    def replace(self, **kw) -> "EstimatorSpec":
        return dataclasses.replace(self, **kw)


EstState = Dict[str, torch.Tensor]


def mbit_list(qspec: QuantizerSpec) -> Tuple[float, ...]:
    """The mantissa bits the MSE search sweeps: 1 .. n_bits - 2 for FP8
    with ``mse_include_mantissa_bits``, else the spec's own (JAX
    ``_mbit_list``)."""
    if qspec.is_fp8 and qspec.mse_include_mantissa_bits:
        return tuple(float(m) for m in range(1, qspec.n_bits - 1))
    return (float(qspec.mantissa_bits),)


def init_state(spec: EstimatorSpec, qspec: QuantizerSpec,
               num_channels: int | None, device=None) -> EstState:
    """The estimator's carry, shapes fixed at build time."""
    c = num_channels if qspec.per_channel else 1
    shape = (num_channels,) if qspec.per_channel else ()
    seen = torch.zeros((), dtype=torch.bool, device=device)
    if spec.kind in (RangeEstimators.allminmax, RangeEstimators.running_minmax):
        return {"xmin": torch.zeros(shape, device=device),
                "xmax": torch.zeros(shape, device=device), "seen": seen}
    if spec.kind == RangeEstimators.MSE:
        n_mbits = len(mbit_list(qspec))
        return {"search_grid": torch.zeros((spec.grid_size, c), device=device),
                "mses": torch.zeros((n_mbits, spec.grid_size, c), device=device),
                "seen": seen}
    if spec.kind == RangeEstimators.line_search:
        n = spec.line_search_size
        return {"thresholds": torch.zeros((n,), device=device),
                "losses": torch.zeros((n, c), device=device),
                "one_sided": torch.zeros((), dtype=torch.bool, device=device),
                "seen": seen}
    return {}


def _squeeze(v: torch.Tensor, per_channel: bool) -> torch.Tensor:
    return v if per_channel else v.reshape(())


def sweep_chunk(x: torch.Tensor) -> int:
    """Candidates per chunk of a sweep over ``x`` (JAX's rule)."""
    return max(1, min(16, int(2e8) // max(1, x.numel())))


def search_steps(num: int, start: float = 0.1, stop: float = 1.2,
                 device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 as the compiled JAX
    calibration step evaluates it (a constant, folded after XLA's
    rewrites): ``r = 1 / (num - 1)``, then ``start * (1 - i * r) + i *
    (stop * r)``, the last point ``stop`` itself."""
    f32 = dict(dtype=torch.float32, device=device)
    if num == 1:
        return torch.tensor([start], **f32)
    start_t, stop_t = torch.tensor(start, **f32), torch.tensor(stop, **f32)
    r = 1.0 / torch.tensor(float(num - 1), **f32)
    i = torch.arange(num - 1, **f32)
    out = start_t * (1.0 - i * r) + i * (stop_t * r)
    return torch.cat([out, stop_t.reshape(1)])


def percentile(x_cn: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """``jnp.percentile(x_cn, qs, axis=-1)`` with ``qs`` a constant, as the
    JAX estimator calls it (linear interpolation), shape ``(len(qs), C)``:
    the float32 position ``q / 100 * (n - 1)`` (``n`` as float32), the
    neighbours from a sort, weights ``h = pos - floor(pos)`` and ``1 - h``,
    ``fma(low, 1 - h, high * h)`` (the fma exact in float64, as XLA's CPU
    code for the compiled calibration step contracts it); indices clamped as XLA's gather clamps them; a row
    with a NaN gives NaN.  No element limit (unlike ``torch.quantile``)."""
    x_cn = x_cn.to(torch.float32)
    n = x_cn.shape[-1]
    f32 = dict(dtype=torch.float32, device=x_cn.device)
    nf = torch.tensor(float(n), **f32)
    q = torch.tensor(list(qs), **f32) / 100.0 * (nf - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w
    zero = torch.zeros((), **f32)
    low = torch.minimum(torch.maximum(low, zero), nf - 1.0)
    high = torch.minimum(torch.maximum(high, zero), nf - 1.0)
    low_i = low.to(torch.int64).clamp(0, n - 1)
    high_i = high.to(torch.int64).clamp(0, n - 1)
    s = torch.sort(x_cn, dim=-1).values
    hi_part = s[:, high_i].t() * high_w[:, None]
    out = (s[:, low_i].t().double() * low_w[:, None].double()
           + hi_part.double()).float()
    has_nan = torch.isnan(x_cn).any(dim=-1)
    return torch.where(has_nan[None, :], torch.full_like(out, float("nan")), out)


def _current_minmax(spec: EstimatorSpec, x_cn: torch.Tensor, per_channel: bool):
    """Last-batch min/max, with symmetric percentile clipping."""
    if spec.percentile:
        lo, hi = percentile(collectives.all_gather(x_cn, dim=-1),
                            [spec.percentile, 100.0 - spec.percentile])
    else:
        lo, hi = collectives.all_minmax(torch.amin(x_cn, dim=-1),
                                        torch.amax(x_cn, dim=-1))
    return _squeeze(lo, per_channel), _squeeze(hi, per_channel)


def _fp8_sq_errors(x_cn: torch.Tensor, maxvals: torch.Tensor, mbits: float,
                   qspec: QuantizerSpec, sign_bits,
                   reduce=torch.mean) -> torch.Tensor:
    """Mean squared FP8 fake-quant error of ``x_cn`` (C, N) at each row of
    candidate maxvals (k, C): ``(k, C)`` (the sum with ``reduce=torch.sum``).
    The values of ``quantize_to_fp8`` (the same constants and per-element
    pipeline)."""
    k, c = maxvals.shape
    consts = fp8_ops.fp8_consts(maxvals.reshape(-1), mbits, qspec.n_bits,
                                sign_bits)
    rows = [r.reshape(k, c, 1) for r in consts]
    xq = fp8_ops.fp8_quantize_rows(x_cn.unsqueeze(0), *rows)
    return reduce((x_cn.unsqueeze(0) - xq) ** 2, dim=-1)


def _int_sq_errors(x_cn: torch.Tensor, maxvals: torch.Tensor,
                   qspec: QuantizerSpec, sign_bits,
                   reduce=torch.mean) -> torch.Tensor:
    """The same on a symmetric uniform grid over [-maxval, maxval] (the MSE
    search's integer branch), one candidate row at a time."""
    out = []
    for mv in maxvals:
        delta, signed = uniform_ops.symmetric_set_quant_range(
            -mv * sign_bits, mv, qspec.n_bits, scale_domain=qspec.scale_domain,
            eps=qspec.eps)
        xq = uniform_ops.quantize_uniform_symmetric(
            x_cn, delta[:, None], signed, qspec.n_bits,
            scale_domain=qspec.scale_domain, eps=qspec.eps)
        out.append(reduce((x_cn - xq) ** 2, dim=-1))
    return torch.stack(out)


def _mse_update(spec: EstimatorSpec, qspec: QuantizerSpec, state: EstState,
                x_cn: torch.Tensor, per_channel: bool):
    """The MSE grid search (JAX ``_mse_update``): candidates
    ``linspace(0.1, 1.2, n) * absmax`` per channel, frozen on the first
    batch; for each mantissa setting the mean squared fake-quant error of
    every candidate, summed over batches; each channel votes for the
    mantissa setting of its smallest error and the plurality wins (first
    on a tie); each channel takes that setting's best candidate."""
    mbits = mbit_list(qspec)
    x_cn = x_cn.to(torch.float32)
    dev = x_cn.device
    dp = collectives.active()
    lo, hi = collectives.all_minmax(torch.amin(x_cn, dim=-1),
                                    torch.amax(x_cn, dim=-1))
    absmax = torch.maximum(torch.abs(lo), torch.abs(hi))
    fresh = search_steps(spec.grid_size, device=dev)[:, None] * absmax[None, :]
    search_grid = torch.where(state["seen"], state["search_grid"], fresh)
    if qspec.allow_unsigned:
        # any element below 0: the (global) min's sign
        sign_bits = torch.any(lo < 0).to(torch.int32)
    else:
        sign_bits = torch.ones((), dtype=torch.int32, device=dev)

    # across ranks each table is a sum, divided by the global count after
    # the reduction
    reduce = torch.sum if dp else torch.mean
    chunk = sweep_chunk(x_cn)
    batch_mses = []
    for m in mbits:
        parts = []
        for i in range(0, search_grid.shape[0], chunk):
            cand = search_grid[i:i + chunk]
            parts.append(_fp8_sq_errors(x_cn, cand, m, qspec, sign_bits, reduce)
                         if qspec.is_fp8 else
                         _int_sq_errors(x_cn, cand, qspec, sign_bits, reduce))
        batch_mses.append(torch.cat(parts))
    batch = torch.stack(batch_mses)                            # (M, n, C)
    if dp:
        batch = collectives.all_sum(batch) / float(
            x_cn.shape[-1] * collectives.size())
    mses = state["mses"] + batch

    votes = torch.argmin(torch.amin(mses, dim=1), dim=0)      # (C,)
    best_idx = torch.argmax(torch.bincount(votes, minlength=len(mbits)))
    best_mbits = torch.tensor(mbits, dtype=torch.float32, device=dev)[best_idx]
    cand_idx = torch.argmin(mses[best_idx], dim=0)            # (C,)
    maxval = torch.gather(search_grid, 0, cand_idx[None, :])[0]

    x_max = _squeeze(maxval, per_channel)
    x_min = -sign_bits.to(torch.float32) * x_max
    new_state = {"search_grid": search_grid, "mses": mses,
                 "seen": torch.ones_like(state["seen"])}
    q_updates = {"mantissa_bits": best_mbits} if qspec.is_fp8 else {}
    return new_state, x_min, x_max, q_updates


def _line_search_update(spec: EstimatorSpec, qspec: QuantizerSpec,
                        state: EstState, x_cn: torch.Tensor, per_channel: bool):
    """The per-channel line search (JAX ``_line_search_update``): each
    threshold quantizes the whole tensor with one per-tensor range, the
    squared error is summed per channel and over batches, and each channel
    takes its best threshold.  Thresholds and one-sidedness are frozen on
    the first batch from the global min/max."""
    from fp8_quantization_tpu_torch.calibration.line_search import (
        candidate_losses)

    x_cn = x_cn.to(torch.float32)
    n = spec.line_search_size
    data_min, data_max = collectives.all_minmax(torch.amin(x_cn),
                                                torch.amax(x_cn))
    one_sided = torch.where(state["seen"], state["one_sided"], data_min >= 0)
    max_pos = (torch.maximum(torch.abs(data_min), torch.abs(data_max))
               + spec.range_margin)
    step = max_pos * spec.expand_range / n
    fresh = step * torch.arange(1, n + 1, dtype=torch.float32, device=x_cn.device)
    thresholds = torch.where(state["seen"], state["thresholds"], fresh)

    losses = state["losses"] + collectives.all_sum(candidate_losses(
        qspec, x_cn, thresholds, one_sided, per_row=True))
    best = torch.argmin(losses, dim=0)                        # (C,)
    x_max = thresholds[best]
    x_min = torch.where(one_sided, torch.zeros_like(x_max), -x_max)
    new_state = {"thresholds": thresholds, "losses": losses,
                 "one_sided": one_sided, "seen": torch.ones_like(state["seen"])}
    return (new_state, _squeeze(x_min, per_channel),
            _squeeze(x_max, per_channel), {})


def update(spec: EstimatorSpec, qspec: QuantizerSpec, state: EstState,
           x_cn: torch.Tensor):
    """One calibration-batch step: ``(new_state, x_min, x_max,
    quantizer_updates)``; x_min / x_max are (C,) per channel, () per
    tensor."""
    pc = qspec.per_channel
    if spec.kind == RangeEstimators.current_minmax:
        lo, hi = _current_minmax(spec, x_cn, pc)
        return state, lo, hi, {}
    if spec.kind == RangeEstimators.MSE:
        return _mse_update(spec, qspec, state, x_cn, pc)
    if spec.kind == RangeEstimators.line_search:
        return _line_search_update(spec, qspec, state, x_cn, pc)
    lo, hi = collectives.all_minmax(torch.amin(x_cn, dim=-1),
                                    torch.amax(x_cn, dim=-1))
    lo, hi = _squeeze(lo, pc), _squeeze(hi, pc)
    seen = state["seen"]
    if spec.kind == RangeEstimators.allminmax:
        lo = torch.where(seen, torch.minimum(state["xmin"], lo), lo)
        hi = torch.where(seen, torch.maximum(state["xmax"], hi), hi)
    elif spec.kind == RangeEstimators.running_minmax:     # EMA with momentum
        m = spec.momentum
        lo = torch.where(seen, (1 - m) * lo + m * state["xmin"], lo)
        hi = torch.where(seen, (1 - m) * hi + m * state["xmax"], hi)
    else:
        raise ValueError(f"unknown estimator kind {spec.kind}")
    new = {"xmin": lo, "xmax": hi, "seen": torch.ones_like(seen)}
    return new, lo, hi, {}

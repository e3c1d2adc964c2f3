"""The paper's analytical SQNR study (BASELINE config 1): for each
distribution (uniform, clipped Gaussian, clipped Student's t) and each
8-bit format (E5M2, E4M3, E3M4, E2M5, INT8), the MSE-optimal clipping range
by line search, then the expected quantization MSE and dot-product MSE,
analytically (closed-form integrals over the grid, analytical/grid.py) and
cross-checked against Monte-Carlo through the port's fake-quant
(analytical/quant_error.py warns where the two differ by more than 10%).

Mirrors ``fp8_quantization_tpu/analytical/study.py``.  The samples are
drawn with numpy's ``RandomState(seed)`` exactly as there, so both
packages quantize the same values; the line search
(``calibration/line_search.line_search_range``, one candidate at a time)
and the fake-quant run on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from fp8_quantization_tpu_torch.analytical import quant_error
from fp8_quantization_tpu_torch.analytical.distributions import (
    ClippedGaussian, ClippedStudentT, Distribution, UniformDistribution)
from fp8_quantization_tpu_torch.calibration.line_search import line_search_range
from fp8_quantization_tpu_torch.device import resolve_device
from fp8_quantization_tpu_torch.ops import quantizer as q
from fp8_quantization_tpu_torch.ops.quantizer import QMethod, QuantizerSpec


@dataclasses.dataclass
class StudyResult:
    distribution: str
    exp_bits: int
    mantissa_bits: int
    range_min: float
    range_max: float
    quant_mse: float
    quant_sqnr_db: float
    dot_prod_mse: float
    dot_prod_sqnr_db: float


def default_distributions() -> List[Distribution]:
    """The study's three distributions."""
    return [
        UniformDistribution(range_min=-1.0, range_max=1.0),
        ClippedGaussian(mu=0.0, sigma=1.0, range_min=-10.0, range_max=10.0),
        ClippedStudentT(nu=8.0, range_min=-100.0, range_max=100.0),
    ]


def _make_quantizer(exp_bits: int, n_bits: int = 8) -> QuantizerSpec:
    """FP8 with ``exp_bits`` exponent bits, or symmetric INT for 0."""
    if exp_bits > 0:
        return QuantizerSpec(method=QMethod.fp_quantizer, n_bits=n_bits,
                             mantissa_bits=n_bits - 1 - exp_bits, set_maxval=True)
    return QuantizerSpec(method=QMethod.symmetric_uniform, n_bits=n_bits)


def run_study_for_distribution(distr: Distribution, n_bits: int = 8,
                               n_samples: int = 5_000_000, seed: int = 10,
                               exp_bits_list=(5, 4, 3, 2, 0),
                               num_candidates: int = 1000, *,
                               device="cuda") -> List[StudyResult]:
    """One distribution's rows of the study, on ``device``."""
    device = resolve_device(device)
    results = []
    rng = np.random.RandomState(seed)
    sample = distr.sample((n_samples,), rng).astype(np.float32)
    sample_dev = torch.from_numpy(sample).to(device)

    for exp_bits in exp_bits_list:
        mantissa_bits = n_bits - 1 - exp_bits
        qspec = _make_quantizer(exp_bits, n_bits)

        rmin, rmax = line_search_range(sample_dev, qspec,
                                       num_candidates=num_candidates)

        state = q.set_quant_range(qspec, q.init_state(qspec, device=device),
                                  torch.tensor(rmin, device=device),
                                  torch.tensor(rmax, device=device))
        grid = q.quantizer_grid(qspec, state)

        def quantize(x_np, state=state, qspec=qspec):
            x = torch.from_numpy(np.ascontiguousarray(x_np)).to(device)
            with torch.no_grad():
                return q.apply(qspec, state, x).cpu().numpy()

        mse = quant_error.compute_expected_quant_mse(
            distr, grid, quantize, n_samples, rng)
        dp_mse = quant_error.compute_expected_dot_prod_mse(
            distr, grid, distr, grid, quantize, quantize,
            num_samples=2_000_000, rng=rng)

        results.append(StudyResult(
            distribution=distr.describe(), exp_bits=exp_bits,
            mantissa_bits=mantissa_bits, range_min=float(rmin),
            range_max=float(rmax), quant_mse=float(mse),
            quant_sqnr_db=quant_error.sqnr_db(mse), dot_prod_mse=float(dp_mse),
            dot_prod_sqnr_db=quant_error.sqnr_db(dp_mse)))
    return results


def format_result(r: StudyResult) -> str:
    """One row as the reference prints it (JAX ``format_result``)."""
    return ("FP8 {} E {} M Quantization: expected MSE {:.2e}  SQNR  {:.2e}\n"
            "{}  expected MSE {:.2e}  SQNR  {:.2e}".format(
                r.exp_bits, r.mantissa_bits, r.quant_mse, r.quant_sqnr_db,
                "Dot product:".rjust(23), r.dot_prod_mse, r.dot_prod_sqnr_db))


def run_full_study(n_samples: int = 5_000_000, seed: int = 10,
                   num_candidates: int = 1000, printer=print, *,
                   device="cuda") -> List[StudyResult]:
    """Every distribution's rows, printed as the reference prints them."""
    all_results = []
    for distr in default_distributions():
        printer("*" * 80)
        printer(distr.describe())
        res = run_study_for_distribution(
            distr, n_samples=n_samples, seed=seed,
            num_candidates=num_candidates, device=device)
        for r in res:
            printer(format_result(r))
        all_results.extend(res)
    return all_results

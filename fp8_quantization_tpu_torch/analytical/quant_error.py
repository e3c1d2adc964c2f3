"""A copy of ``fp8_quantization_tpu/analytical/quant_error.py`` (numpy only;
the port imports nothing of the JAX package).

Expected quantization MSE / dot-product MSE: analytic vs empirical.

Reference: quantization/quant_error_estimator.py.  The analytic side
integrates closed-form bin functionals over the quantizer's grid
(analytical/grid.py); the empirical side Monte-Carlo samples the distribution
and runs the *actual* fake-quant kernel — the built-in cross-validation that
is the reference's de-facto correctness oracle (SURVEY.md §4).
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np

from fp8_quantization_tpu_torch.analytical.distributions import Distribution
from fp8_quantization_tpu_torch.analytical.grid import integrate_over_grid

log = logging.getLogger(__name__)

QuantizeFn = Callable[[np.ndarray], np.ndarray]


def expected_rounding_error(distr: Distribution, grid: np.ndarray) -> float:
    """E[(x - R(x))^2] analytically.  Reference: :35-38."""
    return integrate_over_grid(distr, grid, "sq_error")


def expected_signed_error(distr: Distribution, grid: np.ndarray) -> float:
    """E[x (R(x) - x)] analytically (x-weighted signed rounding error)."""
    return integrate_over_grid(distr, grid, "x_signed")


def expected_dot_prod_error(distr_x: Distribution, grid_x: np.ndarray,
                            distr_y: Distribution, grid_y: np.ndarray) -> float:
    """E[(xy - Q(x)Q(y))^2] for independent x, y via the 6-term expansion.

    Reference: quant_error_estimator.py:40-64.  With ex = Q(x)-x, ey = Q(y)-y:
      E[x²]E[ey²] + E[y²]E[ex²] + E[ex²]E[ey²]
      + 2E[x·ex]E[y·ey] + 2E[ex²]E[y·ey] + 2E[ey²]E[x·ex]
    """
    r_x = expected_rounding_error(distr_x, grid_x)
    r_y = expected_rounding_error(distr_y, grid_y)
    m2_x = distr_x.second_moment()
    m2_y = distr_y.second_moment()
    s_x = expected_signed_error(distr_x, grid_x)
    s_y = expected_signed_error(distr_y, grid_y)
    return (r_x * m2_y + r_y * m2_x + r_x * r_y
            + 2.0 * s_x * s_y + 2.0 * r_x * s_y + 2.0 * r_y * s_x)


def empirical_rounding_error(sample: np.ndarray, quantize: QuantizeFn) -> float:
    """Reference: :67-73."""
    q = np.asarray(quantize(sample))
    return float(np.mean((q - sample) ** 2))


def empirical_dot_prod_error(x: np.ndarray, y: np.ndarray,
                             quantize_x: QuantizeFn, quantize_y: QuantizeFn) -> float:
    """Reference: :76-86."""
    qx = np.asarray(quantize_x(x))
    qy = np.asarray(quantize_y(y))
    return float(np.mean((x * y - qx * qy) ** 2))


def compute_expected_quant_mse(distr: Distribution, grid: np.ndarray,
                               quantize: QuantizeFn, num_samples: int,
                               rng=None, rel_warn: float = 0.1) -> float:
    """Analytic expected MSE, cross-checked against Monte-Carlo.

    Reference: quant_error_estimator.py:135-161 (incl. the >10% warning).
    """
    err_analyt = expected_rounding_error(distr, grid)
    sample = distr.sample((num_samples,), rng).astype(np.float32)
    err_emp = empirical_rounding_error(sample, quantize)
    rel_err = abs((err_emp - err_analyt) / err_analyt)
    if rel_err > rel_warn:
        log.warning(
            "analytic vs empirical quant MSE differ by %.1f%% "
            "(analytic %.3e, empirical %.3e) — consider more samples",
            100 * rel_err, err_analyt, err_emp)
    return err_analyt


def compute_expected_dot_prod_mse(distr_x: Distribution, grid_x: np.ndarray,
                                  distr_y: Distribution, grid_y: np.ndarray,
                                  quantize_x: QuantizeFn, quantize_y: QuantizeFn,
                                  num_samples: int = 2_000_000, rng=None,
                                  rel_warn: float = 0.1) -> float:
    """Analytic expected dot-product MSE with Monte-Carlo cross-check.

    Reference: quant_error_estimator.py:89-132.  (The reference draws the y
    sample from distr_x at :119 — harmless there because callers pass
    distr_x == distr_y; we sample each from its own distribution.)
    """
    err_analyt = expected_dot_prod_error(distr_x, grid_x, distr_y, grid_y)
    x = distr_x.sample((num_samples,), rng).astype(np.float32)
    y = distr_y.sample((num_samples,), rng).astype(np.float32)
    err_emp = empirical_dot_prod_error(x, y, quantize_x, quantize_y)
    rel_err = abs((err_emp - err_analyt) / err_analyt)
    if rel_err > rel_warn:
        log.warning(
            "analytic vs empirical dot-prod MSE differ by %.1f%% "
            "(analytic %.3e, empirical %.3e)", 100 * rel_err, err_analyt, err_emp)
    return err_analyt


def sqnr_db(mse: float) -> float:
    """-10 log10(mse), as printed by the reference study (compute_quant_error.py:32)."""
    return -10.0 * np.log10(mse)

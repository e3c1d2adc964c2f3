"""A copy of ``fp8_quantization_tpu/analytical/grid.py`` (numpy only; the
port imports nothing of the JAX package).

Piecewise-analytic integration of bin functionals over a quantization grid.

Vectorized re-design of the reference's per-interval Python loop
(reference: utils/grid.py:46-93, integrate_pdf_grid_func_analyt): every
half-bin becomes one row of a batched closed-form evaluation, so a 256-point
grid is ~514 vectorized scipy calls instead of ~514 scalar ones.
"""

from __future__ import annotations

import numpy as np

from fp8_quantization_tpu_torch.analytical.distributions import Distribution


def nearest_grid_value(x: float, grid: np.ndarray) -> float:
    """Reference: utils/grid.py:22-26 (quant_scalar_nearest)."""
    grid = np.asarray(grid)
    return float(grid[np.argmin(np.abs(x - grid))])


def rounding_error_abs_nearest(x: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """|x - nearest grid point| per element.  Reference: utils/grid.py:10-19."""
    x = np.asarray(x).reshape(-1, 1)
    return np.min(np.abs(x - np.asarray(grid).reshape(1, -1)), axis=1)


def integrate_over_grid(distr: Distribution, grid: np.ndarray, kind: str) -> float:
    """∑ over grid bins of a closed-form integral against the clipped pdf.

    kind = "sq_error":  ∑ ∫ p(x) (x - R(x))² dx   (expected rounding MSE)
    kind = "x_signed":  ∑ ∫ x p(x) (R(x) - x) dx  (signed x-weighted error)
    where R(x) is round-to-nearest onto ``grid``.  Each bin [g_i, g_{i+1}] is
    split at its midpoint (left half rounds to g_i, right half to g_{i+1});
    integration limits are clamped to the distribution support, and clipping
    point masses at the boundaries are added for clipped distributions.
    Reference: utils/grid.py:46-93.
    """
    if kind == "sq_error":
        fn = distr.bin_sq_error
    elif kind == "x_signed":
        fn = distr.bin_x_weighted_signed
    else:
        raise ValueError(f"unknown kind {kind}")

    grid = np.sort(np.asarray(grid, float))
    rmin, rmax = distr.range_min, distr.range_max
    mid = 0.5 * (grid[:-1] + grid[1:])

    # tails: mass outside the grid rounds to the nearest end point
    a_list = [np.asarray([rmin])] if rmin < grid[0] else []
    b_list = [np.asarray([grid[0]])] if rmin < grid[0] else []
    u_list = [np.asarray([grid[0]])] if rmin < grid[0] else []

    # left halves (round down to g_i) and right halves (round up to g_{i+1})
    a_list += [np.maximum(grid[:-1], rmin), np.maximum(mid, rmin)]
    b_list += [np.minimum(mid, rmax), np.minimum(grid[1:], rmax)]
    u_list += [grid[:-1], grid[1:]]

    if rmax > grid[-1]:
        a_list.append(np.asarray([grid[-1]]))
        b_list.append(np.asarray([rmax]))
        u_list.append(np.asarray([grid[-1]]))

    a = np.concatenate(a_list)
    b = np.concatenate(b_list)
    u = np.concatenate(u_list)
    mask = a < b
    res = float(np.sum(fn(a[mask], b[mask], u[mask])))

    # clipping point masses (zero-mass for the plain uniform distribution)
    if distr.point_mass_range_min or distr.point_mass_range_max:
        q_min = nearest_grid_value(rmin, grid)
        q_max = nearest_grid_value(rmax, grid)
        if kind == "sq_error":
            res += ((q_min - rmin) ** 2 * distr.point_mass_range_min
                    + (q_max - rmax) ** 2 * distr.point_mass_range_max)
        else:
            res += (rmin * (q_min - rmin) * distr.point_mass_range_min
                    + rmax * (q_max - rmax) * distr.point_mass_range_max)
    return res

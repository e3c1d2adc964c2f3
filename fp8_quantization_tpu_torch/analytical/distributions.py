"""A copy of ``fp8_quantization_tpu/analytical/distributions.py`` (numpy and
scipy only; the port imports nothing of the JAX package).

Clipped distributions with closed-form piecewise integrals.

Host-side (numpy/scipy) counterpart of the reference's utils/distributions.py.
Each distribution exposes the two bin-level integrals the expected-MSE
machinery needs, derived here in standardized form (cleaner than, but
algebraically equal to, the reference's expanded erf/₂F₁ expressions):

  bin_sq_error(a, b, u)       = ∫_a^b p(x) (x - u)^2 dx
                                 [reference: integr_interv_p_sqr_r]
  bin_x_weighted_signed(a, b, u) = ∫_a^b x p(x) (u - x) dx = E-contribution of
                                 x·(Q(x) - x) on a bin quantized to u
                                 [reference: integr_interv_x_p_signed_r]

Note: the reference's UniformDistr implements the signed integral as
∫ p (u - x) dx — missing the x weight — which is inconsistent with its own
Gaussian/Student-t implementations and with the dot-product MSE expansion
(quant_error_estimator.py:40-64 needs E[x(Q(x)-x)]).  We implement the
correct x-weighted form for all three (SURVEY.md §7 "known quirks: do not
replicate blindly"); the numeric effect on the symmetric study configs is
negligible since the term is ≈0 there.
"""

from __future__ import annotations

import numpy as np
from scipy import special, stats


class Distribution:
    """Base: a pdf clipped to [range_min, range_max] with boundary point masses."""

    def __init__(self, range_min: float, range_max: float):
        assert range_max >= range_min
        self.range_min = float(range_min)
        self.range_max = float(range_max)
        self.point_mass_range_min = 0.0
        self.point_mass_range_max = 0.0

    # -- sampling / densities ------------------------------------------------
    def sample(self, shape, rng: np.random.RandomState | None = None) -> np.ndarray:
        raise NotImplementedError

    def pdf(self, x):
        raise NotImplementedError

    def cdf(self, x):
        raise NotImplementedError

    # -- closed-form bin integrals ------------------------------------------
    def bin_sq_error(self, a, b, u):
        raise NotImplementedError

    def bin_x_weighted_signed(self, a, b, u):
        raise NotImplementedError

    def second_moment(self) -> float:
        """Non-central second moment of the clipped variable, incl. boundary
        point masses.  Reference: eval_non_central_second_moment."""
        mid = float(np.sum(self.bin_sq_error(
            np.asarray([self.range_min]), np.asarray([self.range_max]), 0.0)))
        return (self.point_mass_range_min * self.range_min ** 2
                + self.point_mass_range_max * self.range_max ** 2 + mid)

    def describe(self) -> str:
        raise NotImplementedError


class UniformDistribution(Distribution):
    """U[range_min, range_max].  Reference: distributions.py:345-384."""

    def __init__(self, range_min=-1.0, range_max=1.0):
        super().__init__(range_min, range_max)
        self.p = 1.0 / (self.range_max - self.range_min)

    def sample(self, shape, rng=None):
        rng = rng or np.random
        return rng.uniform(self.range_min, self.range_max, shape)

    def pdf(self, x):
        x = np.asarray(x)
        return np.where((x >= self.range_min) & (x <= self.range_max), self.p, 0.0)

    def cdf(self, x):
        return np.clip((np.asarray(x) - self.range_min) * self.p, 0.0, 1.0)

    def bin_sq_error(self, a, b, u):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return self.p * ((b - u) ** 3 - (a - u) ** 3) / 3.0

    def bin_x_weighted_signed(self, a, b, u):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return self.p * (u * (b ** 2 - a ** 2) / 2.0 - (b ** 3 - a ** 3) / 3.0)

    def describe(self):
        return f"Uniform distribution on [{self.range_min}, {self.range_max}]"


class ClippedGaussian(Distribution):
    """N(mu, sigma) clipped to [range_min, range_max] (point masses at the
    boundaries).  Reference: distributions.py:49-189.

    Standardized closed forms with φ/Φ the standard normal pdf/cdf and
    α=(a-μ)/σ, β=(b-μ)/σ:
      ∫ p           = Φβ - Φα
      ∫ x p         = μ(Φβ-Φα) + σ(φα-φβ)
      ∫ x² p        = (σ²+μ²)(Φβ-Φα) + σ²(αφα-βφβ) + 2σμ(φα-φβ)
    """

    def __init__(self, mu=0.0, sigma=1.0, range_min=-10.0, range_max=10.0):
        super().__init__(range_min, range_max)
        self.mu, self.sigma = float(mu), float(sigma)
        self.point_mass_range_min = stats.norm.cdf(range_min, mu, sigma)
        self.point_mass_range_max = 1.0 - stats.norm.cdf(range_max, mu, sigma)

    def sample(self, shape, rng=None):
        rng = rng or np.random
        r = rng.normal(self.mu, self.sigma, shape)
        return np.clip(r, self.range_min, self.range_max)

    def pdf(self, x):
        return stats.norm.pdf(np.asarray(x), self.mu, self.sigma)

    def cdf(self, x):
        return stats.norm.cdf(np.asarray(x), self.mu, self.sigma)

    def _phi_terms(self, a, b):
        alpha = (np.asarray(a, float) - self.mu) / self.sigma
        beta = (np.asarray(b, float) - self.mu) / self.sigma
        return alpha, beta, stats.norm.pdf(alpha), stats.norm.pdf(beta), \
            special.ndtr(beta) - special.ndtr(alpha)

    def _moments(self, a, b):
        alpha, beta, pa, pb, dP = self._phi_terms(a, b)
        m0 = dP
        m1 = self.mu * dP + self.sigma * (pa - pb)
        m2 = ((self.sigma ** 2 + self.mu ** 2) * dP
              + self.sigma ** 2 * (alpha * pa - beta * pb)
              + 2.0 * self.sigma * self.mu * (pa - pb))
        return m0, m1, m2

    def bin_sq_error(self, a, b, u):
        m0, m1, m2 = self._moments(a, b)
        return m2 - 2.0 * u * m1 + u ** 2 * m0

    def bin_x_weighted_signed(self, a, b, u):
        _, m1, m2 = self._moments(a, b)
        return u * m1 - m2

    def describe(self):
        return (f"Gaussian distr , mu = {self.mu}, sigma = {self.sigma}, "
                f"clipped at [{self.range_min}, {self.range_max}]")


class ClippedStudentT(Distribution):
    """Standard Student-t(ν) clipped to [range_min, range_max].
    Reference: distributions.py:192-342.

    With C = Γ((ν+1)/2) / (√(νπ) Γ(ν/2)) and q(x) = (1 + x²/ν):
      ∫ p    : C x ₂F₁(1/2, (ν+1)/2; 3/2; -x²/ν)  (antiderivative)
      ∫ x p  : C ν/(1-ν) q(x)^((1-ν)/2)            (antiderivative)
      ∫ x² p : C x³/3 ₂F₁(3/2, (ν+1)/2; 5/2; -x²/ν) (antiderivative)
    """

    def __init__(self, nu=8.0, range_min=-100.0, range_max=100.0):
        super().__init__(range_min, range_max)
        self.nu = float(nu)
        self.point_mass_range_min = stats.t.cdf(range_min, nu)
        self.point_mass_range_max = 1.0 - stats.t.cdf(range_max, nu)
        self._C = (special.gamma(0.5 * (self.nu + 1.0))
                   / np.sqrt(np.pi * self.nu) / special.gamma(0.5 * self.nu))

    def sample(self, shape, rng=None):
        rng = rng or np.random
        r = rng.standard_t(self.nu, size=shape)
        return np.clip(r, self.range_min, self.range_max)

    def pdf(self, x):
        return stats.t.pdf(np.asarray(x), self.nu)

    def cdf(self, x):
        return stats.t.cdf(np.asarray(x), self.nu)

    def _antider_m0(self, x):
        x = np.asarray(x, float)
        return self._C * x * special.hyp2f1(
            0.5, 0.5 * (self.nu + 1.0), 1.5, -(x ** 2) / self.nu)

    def _antider_m1(self, x):
        x = np.asarray(x, float)
        return (self._C * self.nu / (1.0 - self.nu)
                * (1.0 + x ** 2 / self.nu) ** (0.5 * (1.0 - self.nu)))

    def _antider_m2(self, x):
        x = np.asarray(x, float)
        return self._C * x ** 3 / 3.0 * special.hyp2f1(
            1.5, 0.5 * (self.nu + 1.0), 2.5, -(x ** 2) / self.nu)

    def _moments(self, a, b):
        m0 = self._antider_m0(b) - self._antider_m0(a)
        m1 = self._antider_m1(b) - self._antider_m1(a)
        m2 = self._antider_m2(b) - self._antider_m2(a)
        return m0, m1, m2

    def bin_sq_error(self, a, b, u):
        m0, m1, m2 = self._moments(a, b)
        return m2 - 2.0 * u * m1 + u ** 2 * m0

    def bin_x_weighted_signed(self, a, b, u):
        _, m1, m2 = self._moments(a, b)
        return u * m1 - m2

    def describe(self):
        return (f"Student's-t distr , nu = {self.nu}, "
                f"clipped at [{self.range_min}, {self.range_max}]")

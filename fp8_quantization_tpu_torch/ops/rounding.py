"""Rounding ops and their gradient estimators.

Mirrors ``fp8_quantization_tpu/ops/rounding.py``: ``round_ste`` and
``floor_ste`` (identity gradient), ``stochastic_round_ste``,
``scale_gradient``, ``ewgs_round``, ``stacked_sigmoid_round``,
``GradientEstimator`` and ``make_discretizer``.  Each JAX ``custom_vjp``
is a ``torch.autograd.Function`` whose backward is JAX's ``_bwd``, written
with the same operations in the same order.  ``torch.round`` rounds half to
even, as ``jnp.round`` does, which bit-exact parity on grid midpoints
needs.

A discretizer is a ``Discretizer``: callable on a tensor (through
autograd), and exposing ``forward(x) -> (y, saved)`` and ``backward(saved,
g)`` so that a hand-written backward (``ops/fp8._QuantizeToFP8``) applies
the same estimator to the cotangent of its rounding.  Stochastic rounding
draws its noise from an explicit ``torch.Generator``, never from the
global random state; it cannot reproduce JAX's random bits, only their
distribution.
"""

from __future__ import annotations

import enum

import torch

from fp8_quantization_tpu_torch.parallel import collectives


class Discretizer:
    """A rounding op with a gradient estimator (identity gradient here)."""

    def forward(self, x: torch.Tensor):
        return torch.round(x), None

    def backward(self, saved, g: torch.Tensor) -> torch.Tensor:
        return g

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Discretize.apply(x, self)


class _Discretize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, disc):
        y, saved = disc.forward(x)
        ctx.disc, ctx.saved = disc, saved
        return y

    @staticmethod
    def backward(ctx, g):
        return ctx.disc.backward(ctx.saved, g), None


class _Floor(Discretizer):
    def forward(self, x):
        return torch.floor(x), None


class StochasticRound(Discretizer):
    """``floor(x + U[0, 1))`` with an identity gradient (JAX
    ``stochastic_round_ste``); the noise comes from ``generator``.  With
    ``batch_rows`` axis 0 of ``x`` is the batch, and under data
    parallelism each rank rounds with its rows of the noise drawn for the
    global batch (parallel/collectives.rand_rows)."""

    def __init__(self, generator: torch.Generator, batch_rows: bool = False):
        self.generator = generator
        self.batch_rows = batch_rows

    def forward(self, x):
        draw = collectives.rand_rows if self.batch_rows else torch.rand
        noise = draw(x.shape, generator=self.generator, dtype=x.dtype,
                     device=x.device)
        return torch.floor(x + noise), None


class EWGS(Discretizer):
    """Round; backward ``g * (1 + delta * sign(g) * (x - round(x)))`` (JAX
    ``ewgs_round``)."""

    def __init__(self, scaling_factor: float = 0.2):
        self.delta = torch.tensor(scaling_factor, dtype=torch.float32)

    def forward(self, x):
        x_int = torch.round(x)
        return x_int, x - x_int

    def backward(self, diff, g):
        delta = self.delta.to(g.device)
        scale = 1.0 + delta * torch.sign(g) * diff
        return g * scale


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (the product of two float32
    values is exact in float64); constants are float32 values."""
    b = b.to(torch.float64) if isinstance(b, torch.Tensor) else _f32(b)
    c = c.to(torch.float64) if isinstance(c, torch.Tensor) else _f32(c)
    return (a.to(torch.float64) * b + c).to(torch.float32)


_EXP_POLY = (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
             1.6666665459e-1, 5.0000001201e-1)


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as XLA evaluates it on the CPU (the Cephes range
    reduction and polynomial, every step a fused multiply-add), so that the
    stacked-sigmoid surrogate equals JAX's bit for bit; for the small
    arguments it takes (|x| < 89)."""
    x = torch.clamp(x, -88.3762626647950, 88.3762626647949)
    fx = torch.floor(_fma(x, 1.44269504088896341, 0.5))
    r = _fma(fx, -0.693359375, x)
    r = _fma(fx, 2.12194440e-4, r)
    y = torch.full_like(x, 1.9875691500e-4)
    for c in _EXP_POLY:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    return y * torch.exp2(fx)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it on the CPU: ``1 / (1 + exp(-x))``."""
    return 1.0 / (_xla_exp(-x) + 1.0)


class StackedSigmoid(Discretizer):
    """Round; backward the stacked-sigmoid surrogate of JAX
    ``stacked_sigmoid_round``."""

    def __init__(self, alpha: float = 1.0):
        self.alpha = torch.tensor(alpha, dtype=torch.float32)

    def forward(self, x):
        return torch.round(x), x

    def backward(self, x, g):
        alpha = self.alpha.to(g.device)
        sig_min = _sigmoid(alpha / 2.0)
        sig_scale = 1.0 - 2.0 * sig_min
        x_base = torch.floor(x)
        x_rest = x - x_base - 0.5
        s = _sigmoid(x_rest * -alpha)
        grad = s * (1.0 - s) * -alpha / sig_scale
        return grad * g


round_ste = Discretizer()
floor_ste = _Floor()


def stochastic_round_ste(x: torch.Tensor,
                         generator: torch.Generator) -> torch.Tensor:
    """``floor(x + U[0, 1))`` with an identity gradient."""
    return StochasticRound(generator)(x)


def ewgs_round(x: torch.Tensor, scaling_factor: float) -> torch.Tensor:
    """Element-wise gradient scaling (EWGS) discretizer."""
    return EWGS(float(scaling_factor))(x)


def stacked_sigmoid_round(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Round forward, stacked-sigmoid surrogate gradient backward."""
    return StackedSigmoid(float(alpha))(x)


class _ScaleGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_gradient(x: torch.Tensor, scale) -> torch.Tensor:
    """Identity forward; the gradient multiplied by ``scale`` (LSQ)."""
    return _ScaleGradient.apply(x, scale)


class GradientEstimator(str, enum.Enum):
    ste = "ste"
    stoch_round = "stoch_round"
    ewgs = "ewgs"
    stacked_sigmoid = "stacked_sigmoid"


def make_discretizer(estimator: GradientEstimator | str, *,
                     scaling_factor: float = 0.2, alpha: float = 1.0,
                     generator: torch.Generator | None = None,
                     training: bool = False,
                     batch_rows: bool = False) -> Discretizer:
    """The rounding op of ``estimator``.  ``stoch_round`` rounds
    stochastically in training (and then needs ``generator``; its noise
    follows the batch's rows with ``batch_rows``, see StochasticRound) and
    to nearest in evaluation."""
    estimator = GradientEstimator(estimator)
    if estimator == GradientEstimator.ste:
        return round_ste
    if estimator == GradientEstimator.stoch_round:
        if not training:
            return round_ste
        if generator is None:
            raise ValueError("stoch_round needs a torch.Generator in training")
        return StochasticRound(generator, batch_rows)
    if estimator == GradientEstimator.ewgs:
        return EWGS(scaling_factor)
    return StackedSigmoid(alpha)

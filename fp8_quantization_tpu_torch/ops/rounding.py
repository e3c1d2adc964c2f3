"""Straight-through rounding estimators.

Mirrors ``fp8_quantization_tpu/ops/rounding.py`` (``round_ste`` and
``floor_ste``).  ``torch.round`` rounds half to even, as ``jnp.round`` does,
which bit-exact parity on grid midpoints needs.  The stochastic, EWGS and
stacked-sigmoid estimators come with QAT.
"""

from __future__ import annotations

import torch


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _FloorSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.floor(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with an identity gradient."""
    return _RoundSTE.apply(x)


def floor_ste(x: torch.Tensor) -> torch.Tensor:
    """Floor with an identity gradient."""
    return _FloorSTE.apply(x)

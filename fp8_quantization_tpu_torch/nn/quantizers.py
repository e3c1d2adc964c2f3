"""Module that owns one quantizer's state and its range estimator.

Mirrors ``fp8_quantization_tpu/nn/quantizers.py``.  Where the JAX package
keeps the state in the ``quant`` variable collection (``q`` and ``est``),
this module keeps it in buffers: ``maxval``, ``mantissa_bits``,
``sign_bits`` (FP8) or ``delta`` with ``signed`` / ``zero_float``
(uniform), ``initialized`` and, for the accumulating estimators,
``est_xmin``, ``est_xmax``, ``est_seen``.

Modes: ``calibrate`` (estimator update, set range, quantize), ``fixed``
(quantize with the stored state) and ``fp32`` (passthrough).  The QAT modes
``learn`` and ``calibrate_train`` come with QAT.

Outputs: ``out='apply'`` the fake-quantized tensor, ``'factored'``
``(x_norm, factor)`` on the normalized grid, ``'state'`` ``(x, state)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fp8_quantization_tpu_torch.calibration import estimators as est
from fp8_quantization_tpu_torch.ops import quantizer as q

MODES = ("calibrate", "fixed", "fp32")


def channel_major_view(x: torch.Tensor, channel_axis: Optional[int]) -> torch.Tensor:
    """(C, N) view for the estimators; (1, N) when channel_axis is None."""
    if channel_axis is None:
        return x.reshape(1, -1)
    return x.movedim(channel_axis, 0).reshape(x.shape[channel_axis], -1)


class Quantizer(nn.Module):
    """One quantizer + one range estimator, stateful through buffers."""

    def __init__(self, spec: q.QuantizerSpec, range_spec: est.EstimatorSpec,
                 num_channels: Optional[int] = None, channel_axis: int = -1):
        super().__init__()
        self.spec = spec
        self.range_spec = range_spec
        self.channel_axis = channel_axis
        state = q.init_state(spec, num_channels)
        self.state_keys = tuple(state)
        for k, v in state.items():
            self.register_buffer(k, v)
        for k, v in est.init_state(range_spec, spec, num_channels).items():
            self.register_buffer("est_" + k, v)

    def state(self) -> q.QuantState:
        return {k: getattr(self, k) for k in self.state_keys}

    def est_state(self) -> est.EstState:
        return {k[4:]: v for k, v in self.named_buffers(recurse=False)
                if k.startswith("est_")}

    def load_state(self, state: dict, est_state: Optional[dict] = None) -> None:
        """Copy quantizer (and estimator) values into the buffers in place."""
        for k, v in state.items():
            buf = getattr(self, k)
            buf.copy_(torch.as_tensor(v).to(buf.dtype).reshape(buf.shape))
        for k, v in (est_state or {}).items():
            buf = getattr(self, "est_" + k)
            buf.copy_(torch.as_tensor(v).to(buf.dtype).reshape(buf.shape))

    @torch.no_grad()
    def _calibrate(self, x: torch.Tensor) -> None:
        x_cn = channel_major_view(
            x.to(torch.float32), self.channel_axis if self.spec.per_channel else None)
        new_est, x_min, x_max = est.update(self.range_spec, self.spec,
                                           self.est_state(), x_cn)
        new_q = q.set_quant_range(self.spec, self.state(), x_min, x_max)
        self.load_state(new_q, new_est)

    def forward(self, x: torch.Tensor, mode: str = "fixed",
                update_range: bool = True, out: str = "apply"):
        if mode == "fp32":
            return x
        if mode not in MODES:
            raise NotImplementedError(f"quantizer mode {mode!r} is not ported "
                                      "yet (QAT modes come with QAT)")
        if mode == "calibrate" and update_range:
            self._calibrate(x)
        state = self.state()
        if out == "state":
            return x, state
        if out == "factored":
            return q.apply_factored(self.spec, state, x,
                                    channel_axis=self.channel_axis)
        return q.apply(self.spec, state, x, channel_axis=self.channel_axis)

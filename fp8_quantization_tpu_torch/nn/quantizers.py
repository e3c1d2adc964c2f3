"""Module that owns one quantizer's state and its range estimator.

Mirrors ``fp8_quantization_tpu/nn/quantizers.py``.  Where the JAX package
keeps the state in the ``quant`` variable collection (``q`` and ``est``),
this module keeps it in buffers: ``maxval``, ``mantissa_bits``,
``sign_bits`` (FP8) or ``delta`` with ``signed`` / ``zero_float``
(uniform), ``initialized`` and, for the accumulating estimators,
``est_xmin``, ``est_xmax``, ``est_seen`` (the MSE search's
``est_search_grid``, ``est_mses``; the line search's ``est_thresholds``,
``est_losses``, ``est_one_sided``).  An estimator's quantizer updates (the
MSE search's voted ``mantissa_bits``) go into the state with the range.

nn/bake.prepare_inference freezes the fixed quantizer's scalar algebra
into two buffers, as JAX's ``qprep`` collection does (there lines
422-439): ``qprep``, the ``(6, C)`` FP8 constants that fixed mode then
applies (``ops/quantizer.apply_prepared``; the uniform methods have none,
as in JAX), and ``kprep``, the ``(6, 1)`` constants of a per-tensor
quantizer that the kernels take as their output quant (``act_consts``).
Each is stored where the prepare pass's fixed-mode forward first computes
it (``preparing``), so only the quantizers that forward uses are
prepared, and both hold bit for bit what the unprepared path computes on
every call.  Calibrating afterwards updates the state but not these
buffers: the prepared constants are then stale until the prepare pass runs
again.

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
from fp8_quantization_tpu_torch.ops.kernels.common import pack_act_consts

MODES = ("calibrate", "fixed", "fp32")


def preparing(module: nn.Module) -> bool:
    """Whether ``module`` runs in the forward of nn/bake.prepare_inference,
    which stores each fixed-mode constant where it is first computed."""
    return getattr(module, "_preparing", False)


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
        self.register_buffer("qprep", None)
        self.register_buffer("kprep", None)

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
        new_est, x_min, x_max, q_updates = est.update(
            self.range_spec, self.spec, self.est_state(), x_cn)
        new_q = q.set_quant_range(self.spec, self.state(), x_min, x_max)
        new_q.update(q_updates)
        self.load_state(new_q, new_est)

    def act_consts(self):
        """(method, (6, 1) constants) of this quantizer as the kernels'
        output quant (``ops/kernels/common.pack_act_consts``): the
        prepared ones when there are."""
        if preparing(self):
            method, self.kprep = pack_act_consts(self.spec, self.state())
            return method, self.kprep
        if self.kprep is not None:
            return ("fp8" if self.spec.is_fp8 else "int_asym"), self.kprep
        return pack_act_consts(self.spec, self.state())

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
        if mode == "fixed" and preparing(self):
            self.qprep = q.fixed_consts(self.spec, state)
        if mode == "fixed" and self.qprep is not None:
            return q.apply_prepared(self.spec, self.qprep, x,
                                    channel_axis=self.channel_axis,
                                    factored=out == "factored")
        if out == "factored":
            return q.apply_factored(self.spec, state, x,
                                    channel_axis=self.channel_axis)
        return q.apply(self.spec, state, x, channel_axis=self.channel_axis)

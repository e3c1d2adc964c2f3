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
every call.  A spec with ``cast_fastpath`` gets the cast constants in
``qprep`` too (``(12, C)``, ``ops/quantizer.fixed_consts``), so its
prepared fixed mode quantizes by the IEEE cast (the deployment flags of
nn/config.py); ``kprep`` stays on the exact grid, as the JAX kernels
quantize on it whatever the flags.  Calibrating afterwards updates the state but not these
buffers: the prepared constants are then stale until the prepare pass runs
again.

Modes: ``calibrate`` (estimator update, set range, quantize), ``fixed``
(quantize with the stored state), ``fp32`` (passthrough) and the two QAT
modes: ``learn`` (quantize; the state receives gradients) and
``calibrate_train`` (estimator update and set range on every training
forward, no gradient to the state).  Outside ``learn`` the forward takes
the state detached, as JAX stops its gradient.

QAT (JAX training/qat.py) makes the state that ``trainable_param_names``
names trainable: ``make_range_trainable`` turns those buffers into
``nn.Parameter``s of the same name (the reference's
``make_range_trainable``, fp8_quantizer.py:242-254), so ``parameters()``
and the quant-parameter group of training/qat.py split the model as
JAX's ``quant_trainable_mask`` splits its tree.  ``state()`` is detached
whatever the entries are, so what a kernel reads never carries autograd.

Rounding follows the spec's ``grad_estimator`` (JAX ``_discretizer``):
the straight-through round, or in the training modes the stochastic,
EWGS or stacked-sigmoid estimator (``ops/rounding``).  Stochastic
rounding draws from the module's ``noise_generator`` (set by
``set_quant_noise``) and rounds to nearest without one, as JAX does
without its ``quant_noise`` stream.  Under data parallelism an activation
quantizer's rank rounds with its rows of the noise drawn for the global
batch; a weight quantizer draws for its whole tensor.

Under data parallelism (parallel/collectives.py) an estimator's
reductions are global: ``_calibrate`` reduces over the data group inside
the forward, before it sets the range, so that deeper layers calibrate on
the shallower layers' global ranges.  A weight quantizer
(``reduce_over_batch=False``) observes a tensor every rank holds whole
and reduces it locally.

Outputs: ``out='apply'`` the fake-quantized tensor, ``'factored'``
``(x_norm, factor)`` on the normalized grid, ``'state'`` ``(x, state)``.
A bfloat16 input is promoted to float32 first: in JAX its product with
the float32 state is float32, where torch would keep bfloat16 for a
0-dim operand.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from fp8_quantization_tpu_torch.calibration import estimators as est
from fp8_quantization_tpu_torch.ops import quantizer as q
from fp8_quantization_tpu_torch.ops.fp8 import cast_mbits as fp8_cast_mbits
from fp8_quantization_tpu_torch.ops.kernels.common import pack_act_consts
from fp8_quantization_tpu_torch.ops.rounding import make_discretizer
from fp8_quantization_tpu_torch.parallel import collectives
from fp8_quantization_tpu_torch.utils.timing import spanned

MODES = ("calibrate", "calibrate_train", "fixed", "learn", "fp32")
TRAINING_MODES = ("learn", "calibrate_train")


def preparing(module: nn.Module) -> bool:
    """Whether ``module`` runs in the forward of nn/bake.prepare_inference,
    which stores each fixed-mode constant where it is first computed."""
    return getattr(module, "_preparing", False)


def set_quant_noise(model: nn.Module,
                    generator: Optional[torch.Generator]) -> None:
    """Give every quantizer of ``model`` the generator that stochastic
    rounding draws from in the training modes (None: round to nearest)."""
    for m in model.modules():
        if isinstance(m, Quantizer):
            m.noise_generator = generator


def channel_major_view(x: torch.Tensor, channel_axis: Optional[int]) -> torch.Tensor:
    """(C, N) view for the estimators; (1, N) when channel_axis is None."""
    if channel_axis is None:
        return x.reshape(1, -1)
    return x.movedim(channel_axis, 0).reshape(x.shape[channel_axis], -1)


class Quantizer(nn.Module):
    """One quantizer + one range estimator, stateful through buffers."""

    def __init__(self, spec: q.QuantizerSpec, range_spec: est.EstimatorSpec,
                 num_channels: Optional[int] = None, channel_axis: int = -1,
                 reduce_over_batch: bool = True):
        super().__init__()
        self.spec = spec
        self.range_spec = range_spec
        self.channel_axis = channel_axis
        # the channels of a per-channel state (the tensor-parallel rule of
        # parallel/api.tp_axis), None per tensor
        self.num_channels = num_channels if spec.per_channel else None
        self.reduce_over_batch = reduce_over_batch
        state = q.init_state(spec, num_channels)
        self.state_keys = tuple(state)
        for k, v in state.items():
            self.register_buffer(k, v)
        for k, v in est.init_state(range_spec, spec, num_channels).items():
            self.register_buffer("est_" + k, v)
        self.register_buffer("qprep", None)
        self.register_buffer("kprep", None)
        self.noise_generator: Optional[torch.Generator] = None
        # the cast format M of ``qprep``, recorded where it is set; None
        # without the cast path
        self.cast_m: Optional[int] = None

    def make_range_trainable(self, names=None) -> None:
        """Turn the state entries ``names`` (by default those that
        ``trainable_param_names`` names) into parameters of the same names
        and values."""
        for name in (q.trainable_param_names(self.spec) if names is None
                     else names):
            if name in self._buffers:
                value = self._buffers.pop(name)
                self.register_parameter(name, nn.Parameter(value.clone()))

    def state(self) -> q.QuantState:
        """The quantizer's state, detached (what fixed mode and the kernels
        read)."""
        return {k: getattr(self, k).detach() for k in self.state_keys}

    def est_state(self) -> est.EstState:
        return {k[4:]: v for k, v in self.named_buffers(recurse=False)
                if k.startswith("est_")}

    @torch.no_grad()
    def load_state(self, state: dict, est_state: Optional[dict] = None) -> None:
        """Copy quantizer (and estimator) values into the state in place."""
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
        with (contextlib.nullcontext() if self.reduce_over_batch
              else collectives.local()):
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

    @spanned("quantizer")
    def forward(self, x: torch.Tensor, mode: str = "fixed",
                update_range: bool = True, out: str = "apply"):
        if mode == "fp32":
            return x
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.to(torch.float32)
        if mode not in MODES:
            raise ValueError(f"quantizer mode must be one of {MODES}, not "
                             f"{mode!r}")
        if mode in ("calibrate", "calibrate_train") and update_range:
            self._calibrate(x)
        state = (self.state() if mode != "learn" else
                 {k: getattr(self, k) for k in self.state_keys})
        if out == "state":
            return x, state
        disc = self._discretizer(mode)
        if mode == "fixed" and preparing(self):
            self.qprep = q.fixed_consts(self.spec, state)
            self._record_cast_m()
        if mode == "fixed" and self.qprep is not None:
            return q.apply_prepared(self.spec, self.qprep, x,
                                    channel_axis=self.channel_axis,
                                    factored=out == "factored",
                                    cast_mbits=self.cast_m)
        if out == "factored":
            return q.apply_factored(self.spec, state, x,
                                    channel_axis=self.channel_axis,
                                    discretizer=disc)
        return q.apply(self.spec, state, x, channel_axis=self.channel_axis,
                       discretizer=disc)

    def _record_cast_m(self) -> None:
        """Record ``cast_m`` from ``qprep`` (one host read)."""
        self.cast_m = (fp8_cast_mbits(self.qprep[6:])
                       if self.qprep is not None
                       and q.uses_cast(self.spec, self.qprep) else None)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._record_cast_m()

    def _discretizer(self, mode: str):
        """The rounding of the spec's gradient estimator (JAX
        ``Quantizer._discretizer``)."""
        spec = self.spec
        training = mode in TRAINING_MODES and (
            spec.grad_estimator != "stoch_round" or self.noise_generator is not None)
        return make_discretizer(spec.grad_estimator,
                                scaling_factor=spec.ewgs_scaling,
                                alpha=spec.ss_alpha,
                                generator=self.noise_generator,
                                training=training,
                                batch_rows=self.reduce_over_batch)

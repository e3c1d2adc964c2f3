"""Quantized layers: the compute path of the port.

Mirrors ``fp8_quantization_tpu/nn/layers.py``: ``QuantConv``,
``QuantLinear``, ``QuantizedActivation`` and ``_batch_norm`` (running
variance updated with the unbiased batch variance, as torch does, there
lines 730-753).  Per layer:

    weight fake-quant -> conv/linear -> BN (fp32, own running stats)
    -> activation -> output act-quant

Layouts: activations NHWC, weights OIHW / (out, in); weight quantizers are
per channel along dim 0.  Engines (``config.engine``):

* ``parity``: fp32 product on fake-quantized operands (no TF32 on the card);
* ``bf16``: operands on the normalized grid (exact in bf16), products summed
  in fp32, channel factors applied after (there lines 119-266, 1001-1029,
  1235-1246).  On the card the convolution may use TF32: every bf16 value
  is exact in TF32, so the products stay exact and the sums fp32;
* ``fused``: the counterpart of ``pallas`` (there lines 367-520, 784-814,
  856-941).  In fixed mode 1x1 convs (stride 1 or 2) and linears run
  ``ops/kernels/qmatmul`` (FP8 weight quant in the kernel, or baked
  weights), baked 3x3 convs run ``ops/kernels/qconv`` and the ResNet stem
  runs ``ops/kernels/qstem`` (models/resnet.py).  There is no autotune
  gate: the kernels always launch on the card.  Elsewhere the bf16 path
  runs.

Not ported, and rejected where they would be selected: int8 datapaths,
cast fast paths, f8 storage, space-to-depth stems, depthwise / grouped
convs, folded BN and input quantization (nn/config.py raises for those).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fp8_quantization_tpu_torch.nn import factored
from fp8_quantization_tpu_torch.nn.activations import get_activation
from fp8_quantization_tpu_torch.nn.config import LayerQuantConfig
from fp8_quantization_tpu_torch.nn.factored import Factored
from fp8_quantization_tpu_torch.nn.quantizers import Quantizer
from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
from fp8_quantization_tpu_torch.ops.kernels import qconv, qmatmul, qstem

FUSED_ACTIVATIONS = (None, "relu", "relu6")


def factored_act_ok(cfg: LayerQuantConfig) -> bool:
    """Whether a layer's output quant can emit a Factored tensor: a bf16-exact
    normalized grid with a per-tensor factor."""
    return (cfg.engine in ("bf16", "fused") and not cfg.act_quant.per_channel
            and cfg.act_quant.n_bits <= 8)


def act_consts(quantizer: Quantizer) -> torch.Tensor:
    """(6, 1) kernel constants of a per-tensor FP8 act quantizer; maxval is
    floored at 1e-30 as the Pallas wrappers do."""
    st = quantizer.state()
    return fp8_consts(torch.clamp(st["maxval"], min=1e-30),
                      st["mantissa_bits"], quantizer.spec.n_bits,
                      st["sign_bits"])


class QuantizedLayerBase(nn.Module):
    """Shared quantizer, BN and engine plumbing of QuantConv/QuantLinear."""

    def __init__(self, weight_shape, features: int, config: LayerQuantConfig,
                 activation: Optional[str], bn: bool, use_bias: bool,
                 bn_eps: float, bn_momentum: float):
        super().__init__()
        if not config.weight_quant.is_fp8 or not config.act_quant.is_fp8:
            raise NotImplementedError("INT8 slice: uniform quantizers are not "
                                      "ported yet")
        get_activation(activation)
        self.config = config
        self.activation = activation
        self.features = features
        self.bn, self.use_bias = bn, use_bias
        self.bn_eps, self.bn_momentum = bn_eps, bn_momentum
        w = torch.empty(weight_shape)
        nn.init.kaiming_normal_(w, nonlinearity="relu")
        self.weight = nn.Parameter(w)
        if bn:
            self.bn_weight = nn.Parameter(torch.ones(features))
            self.bn_bias = nn.Parameter(torch.zeros(features))
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        self.weight_q = Quantizer(
            config.weight_quant, config.weight_range,
            num_channels=features if config.weight_quant.per_channel else None,
            channel_axis=0)
        self.act_q = Quantizer(config.act_quant, config.act_range)
        # per-channel factor of a baked normalized weight (nn/bake.py)
        self.register_buffer("w_factor", None)
        self._operand_cache = {}

    # ---- shared pieces ----------------------------------------------------

    def _quant_out(self, y, mode, quant_a, out):
        act = get_activation(self.activation)
        if act is not None:
            y = act(y)
        if quant_a and self.config.quant_a:
            if out == "factored" and factored_act_ok(self.config):
                norm, factor = self.act_q(y, mode=mode, out="factored")
                return Factored(norm.to(torch.bfloat16), factor)
            return self.act_q(y, mode=mode)
        return y

    def _batch_norm(self, y, train_bn: bool):
        if train_bn:
            axes = tuple(range(y.ndim - 1))
            mean = y.mean(dim=axes)
            var = y.var(dim=axes, unbiased=False)
            n = y.numel() / self.features
            m = self.bn_momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * n / max(n - 1, 1))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.bn_eps) * self.bn_weight
        return y * inv + (self.bn_bias - mean * inv)

    def _affine_epilogue(self, y, w_factor, x_factor, mode, train_bn):
        """Factors, then BN / bias.  In fixed inference the chain folds into
        one ``y*scale + shift`` (``_fold``), as in the JAX package."""
        if mode == "fixed" and not train_bn:
            scale, shift = self._fold(w_factor, x_factor)
            return y * scale + shift
        if w_factor is not None:
            y = y * w_factor
        if x_factor is not None:
            y = y * x_factor
        if self.bn:
            return self._batch_norm(y, train_bn)
        if self.use_bias:
            return y + self.bias
        return y

    def _engine_operands(self, x, mode, quant_w):
        """(xm, wm, w_factor): under bf16/fused the weight goes onto the
        normalized grid and both operands are rounded to bf16 (held as
        float32 values); ``w_factor`` multiplies the product after."""
        factored_engine = self.config.engine in ("bf16", "fused")
        w_factor = None
        if quant_w and self.config.quant_w:
            if factored_engine:
                wn, wf = self.weight_q(self.weight, mode=mode, out="factored")
                w, w_factor = wn, wf.reshape(-1)
            else:
                w = self.weight_q(self.weight, mode=mode)
        else:
            w = self.weight
            if factored_engine and self.w_factor is not None:
                w_factor = self.w_factor
        if factored_engine:
            return _bf16_exact(x), _bf16_exact(w), w_factor
        return x, w, None

    def _fold(self, w_factor, x_factor):
        """(scale, shift) of fixed-mode inference, per output channel:
        ``y*scale + shift == ((y*w_factor)*x_factor)*bn_inv + bn_shift`` (or
        ``+ bias``), with ``scale = (w_factor*x_factor)*bn_inv``.  The bf16
        engine and the kernels' epilogues both take it, so the two differ
        only in summation order.  (The JAX pallas path multiplies
        ``(bn_inv*x_factor)*w_factor``: one rounding apart.)"""
        if self.bn:
            scale = torch.rsqrt(self.running_var + self.bn_eps) * self.bn_weight
            shift = self.bn_bias - self.running_mean * scale
        else:
            scale = torch.ones(self.features, device=self.weight.device)
            shift = self.bias if self.use_bias else torch.zeros_like(scale)
        fac = w_factor
        if x_factor is not None:
            x_factor = x_factor.reshape(())
            fac = x_factor if fac is None else fac * x_factor
        return (scale if fac is None else fac * scale), shift

    def _act_method(self, quant_a):
        if quant_a and self.config.quant_a:
            return "fp8", act_consts(self.act_q)
        return "none", None

    def _baked(self, quant_w) -> bool:
        return not (quant_w and self.config.quant_w) and self.w_factor is not None

    def _fused_ok(self, mode, train_bn) -> bool:
        return (self.config.engine == "fused" and mode == "fixed"
                and not train_bn and self.activation in FUSED_ACTIVATIONS)

    def _operand(self, kind: str, make):
        """A kernel weight operand derived from ``self.weight``, rebuilt when
        the weight changes (bake, load, device move)."""
        key = (kind, self.weight.device, self.weight._version,
               self.weight.data_ptr())
        hit = self._operand_cache.get(kind)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, make(self.weight.detach()))
            self._operand_cache[kind] = hit
        return hit[1]

    def _fused_matmul(self, x2d, features, mode, quant_w, quant_a, x_factor,
                      out):
        """The qmatmul kernel route (JAX ``_pallas_forward``)."""
        w2d = self.weight.reshape(features, -1)
        if quant_w and self.config.quant_w:
            _, wst = self.weight_q(w2d, mode=mode, out="state")
            w_method, wop = "fp8", w2d.detach().contiguous()
            w_c = fp8_consts(torch.broadcast_to(wst["maxval"].reshape(-1),
                                                (features,)),
                             wst["mantissa_bits"],
                             self.config.weight_quant.n_bits, wst["sign_bits"])
            w_factor = None          # applied in the kernel
        else:
            w_method, w_c = "none", None
            wop = self._operand("matmul", lambda w: w.reshape(features, -1)
                                .to(torch.bfloat16).contiguous())
            w_factor = self.w_factor
        a_method, a_c = self._act_method(quant_a)
        scale, shift = self._fold(w_factor, x_factor)
        emit = (out == "factored" and a_method != "none"
                and factored_act_ok(self.config))
        kcfg = qmatmul.FusedQuantMatmulConfig(
            weight_method=w_method, act_method=a_method,
            activation=self.activation, emit_norm=emit)
        y = qmatmul.fused_quant_matmul(x2d.contiguous(), wop, w_c, a_c,
                                       scale.contiguous(), shift.contiguous(),
                                       cfg=kcfg)
        return Factored(y, a_c[5, 0]) if emit else y


def _bf16_exact(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


class QuantConv(QuantizedLayerBase):
    """Quantized 2-D convolution on NHWC input, optionally BN-fused."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, bn: bool = False,
                 activation: Optional[str] = None, use_bias: bool = False,
                 config: LayerQuantConfig = LayerQuantConfig(),
                 groups: int = 1, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1):
        if groups != 1:
            raise NotImplementedError("grouped / depthwise convs come with "
                                      "the MobileNetV2 slice")
        super().__init__((features, in_features, kernel_size, kernel_size),
                         features, config, activation, bn, use_bias, bn_eps,
                         bn_momentum)
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def fused_state(self, quant_w: bool, quant_a: bool):
        """Baked normalized weight operand, folded (scale, shift) and output
        quant constants for a kernel that runs this layer as part of a
        larger fusion (JAX ``_conv_fused_state``); None unless baked."""
        if not self._baked(quant_w):
            return None
        a_method, a_c = self._act_method(quant_a)
        scale, shift = self._fold(self.w_factor, None)
        return dict(scale=scale, shift=shift, a_method=a_method, a_consts=a_c,
                    factored_ok=factored_act_ok(self.config))

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, train_bn: bool = False,
                out: str = "value"):
        if mode == "fp32":
            mode, quant_w, quant_a = "fixed", False, False
        x, x_factor = factored.split(x)
        k, s, p = self.kernel_size, self.stride, self.padding
        cin = x.shape[-1]
        if self._fused_ok(mode, train_bn):
            if k == 1 and p == 0:
                xs = x if s == 1 else x[:, ::s, ::s, :]
                n, h, w_, c = xs.shape
                y = self._fused_matmul(xs.reshape(-1, c), self.features, mode,
                                       quant_w, quant_a, x_factor, out)
                if isinstance(y, Factored):
                    return Factored(y.norm.reshape(n, h, w_, -1), y.factor)
                return y.reshape(n, h, w_, -1)
            if (k == 3 and p == 1 and s in (1, 2) and self._baked(quant_w)
                    and cin % 8 == 0 and self.features % 8 == 0):
                return self._fused_conv3x3(x, quant_a, x_factor, out)

        xm, wm, w_factor = self._engine_operands(x, mode, quant_w)
        # bf16-exact operands are exact in TF32 too (see module docstring)
        with torch.backends.cudnn.flags(
                enabled=True, allow_tf32=self.config.engine != "parity"):
            y = F.conv2d(xm.to(torch.float32).permute(0, 3, 1, 2), wm,
                         stride=s, padding=p)
        y = self._affine_epilogue(y.permute(0, 2, 3, 1), w_factor, x_factor,
                                  mode, train_bn)
        return self._quant_out(y, mode, quant_a, out)

    def _fused_conv3x3(self, x, quant_a, x_factor, out):
        """The qconv kernel route (JAX ``_pallas_conv3x3``)."""
        a_method, a_c = self._act_method(quant_a)
        scale, shift = self._fold(self.w_factor, x_factor)
        emit = (out == "factored" and a_method != "none"
                and factored_act_ok(self.config))
        kcfg = qconv.FusedConvConfig(act_method=a_method,
                                     activation=self.activation,
                                     emit_norm=emit, stride=self.stride)
        wop = self._operand("conv3x3", qconv.weight_matrix)
        y = qconv.fused_quant_conv3x3(
            x.to(torch.bfloat16).contiguous(), wop, a_c, scale.contiguous(),
            shift.contiguous(), cfg=kcfg)
        return Factored(y, a_c[5, 0]) if emit else y

    def stem_operand(self) -> torch.Tensor:
        """The qstem kernel's (Kp, Cout) bf16 weight matrix."""
        return self._operand("stem", qstem.weight_matrix)


class QuantLinear(QuantizedLayerBase):
    """Quantized dense layer on (..., in_features) input."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 activation: Optional[str] = None,
                 config: LayerQuantConfig = LayerQuantConfig(),
                 bn: bool = False, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1):
        super().__init__((features, in_features), features, config, activation,
                         bn, use_bias, bn_eps, bn_momentum)

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, train_bn: bool = False,
                out: str = "value"):
        if mode == "fp32":
            mode, quant_w, quant_a = "fixed", False, False
        x, x_factor = factored.split(x)
        if self._fused_ok(mode, train_bn):
            lead = x.shape[:-1]
            y = self._fused_matmul(x.reshape(-1, x.shape[-1]), self.features,
                                   mode, quant_w, quant_a, x_factor, out)
            if isinstance(y, Factored):
                return Factored(y.norm.reshape(*lead, -1), y.factor)
            return y.reshape(*lead, -1)
        xm, wm, w_factor = self._engine_operands(x, mode, quant_w)
        y = xm.to(torch.float32) @ wm.t()
        y = self._affine_epilogue(y, w_factor, x_factor, mode, train_bn)
        return self._quant_out(y, mode, quant_a, out)


class QuantizedActivation(nn.Module):
    """Standalone activation quantizer (e.g. after a residual add)."""

    def __init__(self, config: LayerQuantConfig = LayerQuantConfig()):
        super().__init__()
        self.config = config
        self.act_q = Quantizer(config.act_quant, config.act_range)

    def forward(self, x, mode: str = "fixed", quant_a: bool = True,
                update_range: bool = True, out: str = "value"):
        x = factored.materialize(x)
        if mode != "fp32" and quant_a and self.config.quant_a:
            if out == "factored" and factored_act_ok(self.config):
                norm, factor = self.act_q(x, mode=mode,
                                          update_range=update_range,
                                          out="factored")
                return Factored(norm.to(torch.bfloat16), factor)
            return self.act_q(x, mode=mode, update_range=update_range)
        return x

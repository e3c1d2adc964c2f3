"""Layer-level quantization configuration.

Mirrors ``fp8_quantization_tpu/nn/config.py`` (``LayerQuantConfig``,
``make_layer_config``) for FP8 and INT8 PTQ and QAT (``grad_scaling``,
``fp8_learn_maxval``, ``fp8_learn_mantissa_bits``, ``grad_estimator`` with
its EWGS scaling and stacked-sigmoid alpha) and the deployment flags:
``deploy_cast_quant`` (weight and activation quantizers quantize by the
IEEE cast once prepared, bit-exact), ``deploy_cast_ieee`` and
``deploy_act_f8`` (activation quantizers: the cast is the whole
quantizer, stored in bfloat16 or as the 1-byte array), ``conv_out_bf16``
(a composed product re-quantized at once is stored in bfloat16) and
``int8_assume_signed`` (the int8 route drops the unsigned-grid terms;
nn/bake.bake_int8_weights checks the claim), with JAX's defaults, all off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from fp8_quantization_tpu_torch.calibration.estimators import (
    EstimatorSpec, RangeEstimators)
from fp8_quantization_tpu_torch.ops.quantizer import QMethod, QuantizerSpec
from fp8_quantization_tpu_torch.ops.rounding import GradientEstimator

ENGINES = ("parity", "bf16", "fused")
BN_MODES = ("fp32_after", "folded")


@dataclasses.dataclass(frozen=True)
class LayerQuantConfig:
    """Everything a quantized layer needs to know, statically.

    ``engine``:
      'parity' - fp32 conv/matmul on fake-quantized operands;
      'bf16'   - operands on the normalized grid, exact in bf16, products
                 summed in fp32, channel factors applied after the product;
      'fused'  - the counterpart of the JAX 'pallas' engine: in fixed mode
                 the stem, the 3x3 convs (both baked), the 1x1 convs and
                 linears and the ViT's attention run the hand-written
                 kernels in ops/kernels/.

    ``quantize_input``: each layer quantizes its input (not its output).
    ``int8_mxu``: with ``quantize_input``, symmetric-uniform weights and
    asymmetric-uniform activations, fixed-mode layers run the s8 x s8 -> s32
    datapath (ops/int8.py; under 'fused' the int8 kernels).
    ``bn_mode``: 'fp32_after' keeps BN after the quantized product;
    'folded' multiplies the BN scale into the weights before they are
    quantized and keeps only the folded shift (an inference-time mode).
    ``conv_out_bf16``: in fixed mode a composed conv or linear whose output
    its own quantizer re-quantizes at once into a ``Factored`` tensor
    stores the float32 product in bfloat16, and the ops/int8 route returns
    bfloat16 (JAX ``_conv_out_dtype``; the kernels ignore it, as JAX's do).
    ``int8_assume_signed``: the int8 route takes every weight grid as
    signed and drops its ``s_w`` terms (``ops/int8``).
    """

    weight_quant: QuantizerSpec = QuantizerSpec()
    act_quant: QuantizerSpec = QuantizerSpec()
    weight_range: EstimatorSpec = EstimatorSpec(kind=RangeEstimators.current_minmax)
    act_range: EstimatorSpec = EstimatorSpec(kind=RangeEstimators.running_minmax)
    quantize_input: bool = False
    quant_w: bool = True
    quant_a: bool = True
    engine: str = "parity"
    int8_mxu: bool = False
    bn_mode: str = "fp32_after"
    conv_out_bf16: bool = False
    int8_assume_signed: bool = False

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {self.engine!r}")
        if self.bn_mode not in BN_MODES:
            raise ValueError(f"bn_mode must be one of {BN_MODES}, got {self.bn_mode!r}")

    def replace(self, **kw) -> "LayerQuantConfig":
        return dataclasses.replace(self, **kw)

    def with_weight_bits(self, n_bits: int) -> "LayerQuantConfig":
        return self.replace(weight_quant=self.weight_quant.replace(n_bits=n_bits))

    def with_act_bits(self, n_bits: int) -> "LayerQuantConfig":
        return self.replace(act_quant=self.act_quant.replace(n_bits=n_bits))

    def fp32_acts(self) -> "LayerQuantConfig":
        return self.replace(quant_a=False)


def make_layer_config(
    qmethod: str | QMethod = QMethod.fp_quantizer,
    act_qmethod: str | QMethod | None = None,
    n_bits: int = 8,
    n_bits_act: Optional[int] = None,
    per_channel_weights: bool = False,
    scale_domain: str = "linear",
    weight_range_method: str | RangeEstimators = RangeEstimators.current_minmax,
    act_range_method: str | RangeEstimators = RangeEstimators.running_minmax,
    percentile: Optional[float] = None,
    act_momentum: Optional[float] = None,
    num_candidates: Optional[int] = None,
    act_num_candidates: Optional[int] = None,
    fp8_maxval: Optional[float] = None,
    fp8_mantissa_bits: int = 4,
    fp8_set_maxval: bool = False,
    fp8_learn_maxval: bool = False,
    fp8_learn_mantissa_bits: bool = False,
    fp8_mse_include_mantissa_bits: bool = True,
    fp8_allow_unsigned: bool = False,
    grad_scaling: bool = False,
    grad_estimator: str = "ste",
    ewgs_scaling: float = 0.2,
    ss_alpha: float = 1.0,
    quantize_input: bool = False,
    int8_mxu: bool = False,
    bn_mode: str = "fp32_after",
    engine: str = "parity",
    conv_out_bf16: bool = False,
    deploy_cast_quant: bool = False,
    deploy_act_f8: bool = False,
    int8_assume_signed: bool = False,
    deploy_cast_ieee: bool = False,
) -> LayerQuantConfig:
    """Build a LayerQuantConfig from the JAX package's flag values; the same
    qmethod and FP8 options feed weight and act quantizers.  The MSE grid
    has ``num_candidates`` points for the weights and
    ``act_num_candidates`` (else ``num_candidates``) for the activations,
    111 when neither is given.  ``deploy_cast_quant`` sets both specs'
    ``cast_fastpath``; ``deploy_cast_ieee`` and ``deploy_act_f8`` set the
    activation spec's ``cast_fastpath`` with ``cast_ieee_subnorm`` or
    ``store_f8`` (JAX there lines 152-162)."""
    qmethod = QMethod(qmethod)
    act_qmethod = QMethod(act_qmethod) if act_qmethod else qmethod

    def _qspec(method: QMethod, bits: int, per_channel: bool) -> QuantizerSpec:
        return QuantizerSpec(method=method, n_bits=bits, per_channel=per_channel,
                             scale_domain=scale_domain,
                             grad_scaling=grad_scaling,
                             mantissa_bits=fp8_mantissa_bits, maxval=fp8_maxval,
                             set_maxval=fp8_set_maxval,
                             learn_maxval=fp8_learn_maxval,
                             learn_mantissa_bits=fp8_learn_mantissa_bits,
                             mse_include_mantissa_bits=fp8_mse_include_mantissa_bits,
                             allow_unsigned=fp8_allow_unsigned,
                             cast_fastpath=deploy_cast_quant,
                             grad_estimator=GradientEstimator(grad_estimator).value,
                             ewgs_scaling=ewgs_scaling, ss_alpha=ss_alpha)

    act_kwargs = {} if act_momentum is None else {"momentum": act_momentum}
    act_spec = _qspec(act_qmethod, n_bits_act or n_bits, False)
    if deploy_cast_ieee:
        act_spec = act_spec.replace(cast_fastpath=True, cast_ieee_subnorm=True)
    if deploy_act_f8:
        act_spec = act_spec.replace(cast_fastpath=True, store_f8=True)
    return LayerQuantConfig(
        weight_quant=_qspec(qmethod, n_bits, per_channel_weights),
        act_quant=act_spec,
        weight_range=EstimatorSpec(kind=RangeEstimators(weight_range_method),
                                   percentile=percentile,
                                   num_candidates=num_candidates),
        act_range=EstimatorSpec(kind=RangeEstimators(act_range_method),
                                percentile=percentile,
                                num_candidates=act_num_candidates or num_candidates,
                                **act_kwargs),
        quantize_input=quantize_input, engine=engine, int8_mxu=int8_mxu,
        bn_mode=bn_mode, conv_out_bf16=conv_out_bf16,
        int8_assume_signed=int8_assume_signed)

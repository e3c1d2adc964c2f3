"""Quantized layers: the compute path of the port.

Mirrors ``fp8_quantization_tpu/nn/layers.py``: ``QuantConv``,
``QuantLinear``, ``QuantLayerNorm``, ``QuantizedActivation`` and
``_batch_norm`` (running variance updated with the unbiased batch variance,
as torch does, there lines 730-753; under data parallelism the batch
statistics are taken over the data group, parallel/collectives.py).  Per layer:

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
  856-941).  In fixed mode, for FP8 or symmetric-uniform weights and FP8 or
  per-tensor asymmetric-uniform activations (JAX ``_pallas_supported``,
  there lines 268-282), 1x1 convs (stride 1 or 2) and linears with no
  activation, relu or relu6 run ``ops/kernels/qmatmul`` (FP8 or int_sym
  weight quant in the kernel, or baked weights; under ``quantize_input``
  the input quantized in the kernel; a gelu linear takes the bf16 path, as
  in JAX), baked 3x3 convs run ``ops/kernels/qconv`` and the ResNet stem
  runs ``ops/kernels/qstem`` (models/resnet.py), each with its output
  quant (FP8 or int_asym) in the epilogue.  Under ``quantize_input`` the
  3x3 and depthwise convs and the stem take the bf16 path, as in JAX
  (there lines 901-903, 987, 795-799).  Elsewhere the bf16 path runs, so
  QAT's modes (``learn``, ``calibrate_train``, with ``train_bn``) train on
  the bf16 route, as JAX's ``pallas`` engine does (there lines 268-272).

The kernel gate (ops/kernels/autotune.py, JAX's ops/pallas/autotune.py):
where a ``fused`` layer may take a kernel, the kernel runs only if its
gate says so (``gated_route``), and otherwise the layer's own ``bf16``
route: the 1x1 convs and linears behind ``pallas_wins(M, K, N)`` with M
the rows of the product (JAX ``_pallas_wins``, there lines 301-313), the
3x3 convs behind ``conv3_group`` (there lines 919-941), the depthwise 3x3
convs behind ``dw_group`` (there lines 976-991) and the int8 3x3 convs
behind ``conv3_int8_group``, the int8 1x1 convs and linears behind
``int8_matmul_wins``; the stem, the MobileNetV2 block and the ViT
attention behind ``stem_group``, ``ir_group`` and ``attn_wins`` in their
models.  By default (``auto``) a gate races the kernel against the
composed route on the card the first time it sees a shape and keeps the
winner; on CPU tensors it answers "kernel" (the plain version).

The int8 datapath (``int8_datapath``: ``int8_mxu`` + ``quantize_input``,
symmetric-uniform weights, per-tensor asymmetric-uniform inputs, <= 8
bits) takes every fixed-mode layer on every engine, as the JAX package's
``_int8_xla_ok`` route does (there lines 629-727, 943-970, 1182-1220): a
``Factored`` input is materialized and re-quantized by the layer's own
input quantizer.  On ``parity`` and ``bf16`` it runs ``ops/int8``; on
``fused`` the 3x3 convs (Cin, Cout divisible by 16) run
``ops/kernels/qconv_int8`` where ``conv3_int8_group`` says so, the 1x1
convs and linears ``ops/kernels/qmatmul_int8`` where ``int8_matmul_wins``
says so (JAX takes ops/int8 there unraced outside ``always``, there lines
857, 1187), and everything else ``ops/int8`` (the depthwise convs through
its grouped ``int8_conv``; general grouped convs take the composed path,
as in JAX, there lines 1011-1022).  Weights baked by
``nn/bake.bake_int8_weights`` (``w_int8``, ``w_delta``, ``w_signed``) are
taken whatever ``quant_w`` is.

The s8 interchange (``nn/factored.PrequantS8``, JAX there lines 65-80,
1146-1220, 1275-1281): a ``QuantLinear`` on the int8 datapath takes a
``PrequantS8`` input, its operand already on the layer's input grid
(``int8_input_grid``), through ``ops/int8.int8_matmul(x_prequant=True)``,
or under ``fused`` the s8 input branch of ``ops/kernels/qmatmul_int8``
(gate ``int8_matmul_wins`` with ``prequant_x``; a K the branch does not
take goes composed before the gate); with ``emit_s8`` (the next
consumer's grid) it returns a ``PrequantS8`` from ops/int8's epilogue, as
no kernel emits s8; ``QuantLayerNorm(emit_s8=...)`` returns one before
its own output quant.  The ViT wires them (models/vit.py).

Folded BN (``config.bn_mode == 'folded'``, JAX ``_bn_folded_kernel``,
there lines 315-334): the BN scale multiplies the weights per output
channel before they are quantized, in every mode, and only the folded
shift ``beta - mean*inv`` follows the product (``_kernel``, ``_fold``).

Depthwise convs (``groups == in_features == features``) run
``F.conv2d(groups=C)``; under ``fused`` in fixed mode a baked depthwise 3x3
(stride 1 or 2, SAME padding, C >= 32) runs ``ops/kernels/qdwconv`` (the
static conditions of JAX lines 976-987) where ``dw_group`` says so.
``QuantConv.fused_state`` hands a MobileNetV2 block its stages' baked
operands for ``ops/kernels/qblock`` (models/mobilenet_v2.py).

A ``Factored`` input to a layer that quantizes its input
(``quantize_input``) is materialized and re-quantized by the layer's own
input quantizer on every engine, as the reference (``parity``) and the int8
datapath do.  JAX's bf16 engine instead takes the ``Factored`` value
unquantized (there lines 1001-1004, 1235-1238) and its ``pallas`` engine
quantizes the norm with this layer's step (ROADMAP.md section C).

Prepared layers (nn/bake.prepare_inference, JAX nn/bake.py:199-263): the
prepare pass runs one fixed-mode forward in which each layer stores the
scalar algebra it computes (at a gated site both routes' unless the
gate's mode settles the route, ``gated_route``), and later fixed-mode
forwards read it back:
the quantizers' constants (nn/quantizers.py: ``qprep``, ``kprep``), the
fold ``(scale, shift)`` (``prep_fold``, taken only when the layer sees the
same kind of weight and input factor as in the prepare pass), the
in-kernel weight quantizer's constants (``prep_w_consts``), the int8
routes' scalars (``prep_int8_w_delta``, ``prep_int8_scalars``) and the
kernels' weight operands (``prep_op_<kind>``: the bf16 matrices, taps and
the unbaked int8 route's float32 matrix, ``_operand``), which an exported
program (serving/export.py) then holds as constants.  Each is what the
unprepared forward computes, so the logits stay bit-identical.
Calibrating or baking afterwards leaves them stale until the prepare pass
runs again.  Under the int8 datapath the port also freezes the integer
constants, which JAX recomputes.

The space-to-depth stem (``QuantConv(s2d=...)``, JAX there lines
772-782, 1008-1019): a 7x7/2 conv with padding 3 runs as the exact 4x4/1
conv on the s2d input (ops/s2d.py), the rearrangement applied after the
weight fake-quant on the general conv path, which it always takes (not
the int8 route: there lines 845-847).  Under ``s2d='input'`` the input
arrives s2d'd, (N, H/2, W/2, 4C), and the weight keeps its (F, C, 7, 7)
geometry.

The deployment flags (nn/config.py): the output quant stores its norm
through ``factored.storage_dtype`` (1 byte under ``deploy_act_f8``) and
every layer reads a ``Factored`` input through ``factored.split`` /
``materialize``, which upcast it exactly; under ``conv_out_bf16`` a
composed conv or linear whose output goes straight into its own output
quant as a ``Factored`` tensor rounds its float32 product to bfloat16 and
takes it back to float32 before the epilogue (JAX ``_conv_out_dtype``
and its ``astype(float32)``, there lines 285-299, 1024-1030, 1241-1242),
and the ops/int8 route returns bfloat16 with ``int8_assume_signed``
passed on (there lines 969-970, 1213-1214).  The kernels ignore these
flags, as the Pallas kernels do: they quantize on the exact grid, read
bfloat16 and store a bfloat16 norm (the int8 kernels float32), except
that the int8 matmul's route rounds the kernel's float32 output to
bfloat16 under ``conv_out_bf16``, as the ops/int8 route it races stores
it (JAX's pallas engine takes that route there).

``QuantConv1d`` and ``QuantConvTranspose`` (JAX there lines 1032-1130)
take the composed path on every engine, as in JAX, which has no kernel
or int8 route for them.  Their weights are (out, in/groups, *k), the output
channel first as in every layer here, which ``models/convert`` transposes
from JAX's (*k, in, out).
"""

from __future__ import annotations

import contextlib
import math
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fp8_quantization_tpu_torch.nn import factored
from fp8_quantization_tpu_torch.nn.activations import get_activation
from fp8_quantization_tpu_torch.nn.config import LayerQuantConfig
from fp8_quantization_tpu_torch.nn.factored import Factored, PrequantS8
from fp8_quantization_tpu_torch.nn.quantizers import Quantizer, preparing
from fp8_quantization_tpu_torch.ops import int8 as int8_ops
from fp8_quantization_tpu_torch.ops import s2d as s2d_ops
from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
from fp8_quantization_tpu_torch.ops.kernels import (
    autotune, qconv, qconv_int8, qdwconv, qmatmul, qmatmul_int8, qstem)
from fp8_quantization_tpu_torch.ops.quantizer import QMethod
from fp8_quantization_tpu_torch.ops.uniform import (
    _scale_from_delta, int_sym_consts)
from fp8_quantization_tpu_torch.parallel import collectives

FUSED_ACTIVATIONS = (None, "relu", "relu6")
# QuantConv's space-to-depth stem (ops/s2d.py, JAX nn/layers.py:772-782):
# off, the input transformed in the layer, or the input already s2d'd
S2D_MODES = (False, True, "input")


def int8_datapath(cfg: LayerQuantConfig) -> bool:
    """Whether fixed-mode layers under ``cfg`` run the s8 x s8 -> s32
    datapath (JAX ``int8_interchange_ok``, the static part of
    ``_int8_xla_ok``)."""
    return (cfg.int8_mxu and cfg.quantize_input and cfg.quant_a
            and cfg.act_quant.method == QMethod.asymmetric_uniform
            and not cfg.act_quant.per_channel and cfg.act_quant.n_bits <= 8
            and cfg.weight_quant.method == QMethod.symmetric_uniform
            and cfg.weight_quant.n_bits <= 8)


# JAX's name for the model-level predicate of the s8 interchange
# (nn/factored.PrequantS8): the same static conditions
int8_interchange_ok = int8_datapath


def layer_weight_spec(model: nn.Module):
    """The models' ``weight_spec_fn``: module path (a tuple of names) -> the
    weight spec of the quantized layer there, as its preset configured it."""
    return lambda path: model.get_submodule(".".join(path)).weight_q.spec


def factored_act_ok(cfg: LayerQuantConfig) -> bool:
    """Whether a layer's output quant can emit a Factored tensor: a bf16-exact
    normalized grid with a per-tensor factor."""
    return (cfg.engine in ("bf16", "fused") and not cfg.act_quant.per_channel
            and cfg.act_quant.n_bits <= 8)


def out_quant(config: LayerQuantConfig, quantizer: Quantizer, quant_a: bool):
    """(method, (6, 1) constants or None) of an activation quantizer for the
    kernels (``common.pack_act_consts``): "fp8" or "int_asym", or "none"
    when it does not quantize."""
    if quant_a and config.quant_a:
        return quantizer.act_consts()
    return "none", None


def stage_state(config: LayerQuantConfig, quantizer: Quantizer,
                quant_a: bool) -> dict:
    """The output-quant part of a fused stage's state (JAX
    ``out='fused_state'``): method, constants, the Factored output's
    factor (None when the stage does not quantize) and whether the stage
    may emit a Factored tensor."""
    method, consts = out_quant(config, quantizer, quant_a)
    return dict(a_method=method, a_consts=consts,
                factor=None if consts is None else consts[5, 0],
                factored_ok=factored_act_ok(config))


def quantizes_output(config: LayerQuantConfig, quant_a: bool) -> bool:
    """Whether a layer quantizes its output (not its input instead)."""
    return quant_a and config.quant_a and not config.quantize_input


def emits_factored(config: LayerQuantConfig, quant_a: bool, out: str) -> bool:
    """Whether a layer's output quant emits a ``Factored`` tensor."""
    return (quantizes_output(config, quant_a) and out == "factored"
            and factored_act_ok(config))


def quant_output(config: LayerQuantConfig, quantizer: Quantizer, y, mode,
                 quant_a: bool, out: str):
    """A layer's output quant (JAX ``_quant_out`` after the activation):
    ``Factored`` under ``out='factored'`` where the config allows it, the
    fake-quantized value otherwise, ``y`` itself when the layer quantizes
    its input instead or does not quantize."""
    if emits_factored(config, quant_a, out):
        norm, factor = quantizer(y, mode=mode, out="factored")
        return Factored(factored.storage_dtype(norm), factor)
    if quantizes_output(config, quant_a):
        return quantizer(y, mode=mode)
    return y


def round_conv_out(config: LayerQuantConfig, y, mode, quant_a: bool, out: str):
    """A composed product ``y`` (float32) as the layer stores it: rounded to
    bfloat16 under ``conv_out_bf16`` when the output goes straight into the
    layer's own output quant as a ``Factored`` tensor in fixed mode (JAX
    ``_conv_out_dtype``), then float32 again, as JAX casts it back before
    the epilogue."""
    if config.conv_out_bf16 and mode == "fixed" and emits_factored(config, quant_a, out):
        return y.to(torch.bfloat16).to(torch.float32)
    return y


@contextlib.contextmanager
def route_log(model: nn.Module, mode: str):
    """While active, each gated site of ``model`` (``gated_route``) records
    (``"record"``) or replays (``"replay"``) its route, in its module's
    ``_export_route``.  The serving export (serving/export.py) records one
    real forward, then traces with the recorded routes: a gate asked on
    fake tensors would race nothing and key on a symbolic batch."""
    if mode not in ("record", "replay"):
        raise ValueError(f"route_log mode must be 'record' or 'replay', not "
                         f"{mode!r}")
    modules = list(model.modules())
    for m in modules:
        m._route_log = mode
    try:
        yield
    finally:
        for m in modules:
            m._route_log = None


def gated_route(module: nn.Module, gate, kernel, composed):
    """A gated kernel site (ops/kernels/autotune.py): ``kernel()`` where
    ``gate(kernel=kernel, composed=composed)`` says so, else
    ``composed()``; a gate that races times those two calls.  In the
    prepare pass (nn/bake.prepare_inference) of a mode that does not settle
    every answer (``autotune.settled``), the gate is not asked: both routes
    run, the composed one first, and the kernel's output goes on, so that
    each route stores its prepared constants whatever verdict a later
    forward meets, and no verdict is raced or recorded at the prepare
    pass's shapes.  Under ``route_log`` the route taken is recorded, or
    the recorded one replayed (a site with none raises)."""
    log = getattr(module, "_route_log", None)
    if log == "replay":
        take = getattr(module, "_export_route", None)
        if take is None:
            raise RuntimeError(f"{type(module).__name__}: no route recorded "
                               f"at this gated site")
        return kernel() if take else composed()
    if preparing(module) and not autotune.settled():
        composed()
        return kernel()
    take = bool(gate(kernel=kernel, composed=composed))
    if log == "record":
        module._export_route = take
    return kernel() if take else composed()


class QuantizedLayerBase(nn.Module):
    """Shared quantizer, BN and engine plumbing of QuantConv/QuantLinear."""

    def __init__(self, weight_shape, features: int, config: LayerQuantConfig,
                 activation: Optional[str], bn: bool, use_bias: bool,
                 bn_eps: float, bn_momentum: float):
        super().__init__()
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
            channel_axis=0, reduce_over_batch=False)
        self.act_q = Quantizer(config.act_quant, config.act_range)
        # per-channel factor of a baked normalized weight (nn/bake.py)
        self.register_buffer("w_factor", None)
        # the int8 bake (nn/bake.bake_int8_weights): the (C, K) recentred
        # grid in the int8 kernels' layout, its step and signedness
        self.register_buffer("w_int8", None)
        self.register_buffer("w_delta", None)
        self.register_buffer("w_signed", None)
        # what the prepare pass stores (see the module docstring)
        self.register_buffer("prep_fold", None)
        self.register_buffer("prep_w_consts", None)
        self.register_buffer("prep_int8_w_delta", None)
        self.register_buffer("prep_int8_scalars", None)
        self._prep_fold_key = None
        self._operand_cache = {}

    # ---- shared pieces ----------------------------------------------------

    def _quant_in_engine(self, x, mode, quant_a):
        """(x', x_factor): input quantization under ``quantize_input``; the
        bf16 and fused engines take the normalized grid and its factor."""
        if self._quantizes_input(quant_a):
            if self.config.engine in ("bf16", "fused"):
                return self.act_q(x, mode=mode, out="factored")
            return self.act_q(x, mode=mode), None
        return x, None

    def _quantizes_input(self, quant_a) -> bool:
        return self.config.quantize_input and quant_a and self.config.quant_a

    def _quant_out(self, y, mode, quant_a, out):
        act = get_activation(self.activation)
        if act is not None:
            y = act(y)
        return quant_output(self.config, self.act_q, y, mode, quant_a, out)

    def _batch_norm(self, y, train_bn: bool):
        if train_bn:
            axes = tuple(range(y.ndim - 1))
            n = y.numel() / self.features
            if collectives.active():
                # the batch is sharded over the data group: the global
                # mean and (two-pass) variance, through a sum whose
                # backward sums the ranks' gradients
                n = n * collectives.size()
                mean = collectives.all_sum_grad(y.sum(dim=axes)) / n
                var = collectives.all_sum_grad(
                    ((y - mean) ** 2).sum(dim=axes)) / n
            else:
                mean = y.mean(dim=axes)
                var = y.var(dim=axes, unbiased=False)
            m = self.bn_momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * n / max(n - 1, 1))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.bn_eps) * self.bn_weight
        return y * inv + (self.bn_bias - mean * inv)

    def _affine_epilogue(self, y, w_factor, x_factor, mode, train_bn):
        """Factors, then BN / folded shift / bias.  In fixed inference the
        chain folds into one ``y*scale + shift`` (``_fold``), as in the JAX
        package."""
        if mode == "fixed" and not train_bn:
            scale, shift = self._fold(w_factor, x_factor)
            return y * scale + shift
        if w_factor is not None:
            y = y * w_factor
        if x_factor is not None:
            y = y * x_factor
        if self._folded():
            return y + self._bn_inv_shift()[1]
        if self.bn:
            return self._batch_norm(y, train_bn)
        if self.use_bias:
            return y + self.bias
        return y

    def _folded(self) -> bool:
        return self.bn and self.config.bn_mode == "folded"

    def _bn_inv_shift(self):
        """(inv, shift) of BN on its running statistics."""
        inv = torch.rsqrt(self.running_var + self.bn_eps) * self.bn_weight
        return inv, self.bn_bias - self.running_mean * inv

    def _kernel(self) -> torch.Tensor:
        """The weight the quantizer sees: under folded BN the BN scale
        multiplies each output channel (dim 0) first (JAX
        ``_bn_folded_kernel``)."""
        if not self._folded():
            return self.weight
        inv = self._bn_inv_shift()[0]
        return self.weight * inv.reshape(-1, *[1] * (self.weight.ndim - 1))

    def _check_train_bn(self, train_bn: bool) -> None:
        if train_bn and self._folded():
            raise ValueError("bn_mode='folded' is an inference-time mode; "
                             "train with bn_mode='fp32_after'")

    def _engine_operands(self, x, mode, quant_w):
        """(xm, wm, w_factor): under bf16/fused the weight goes onto the
        normalized grid and both operands are rounded to bf16 (held as
        float32 values); ``w_factor`` multiplies the product after."""
        factored_engine = self.config.engine in ("bf16", "fused")
        w_factor = None
        kernel = self._kernel()
        if quant_w and self.config.quant_w:
            if factored_engine:
                wn, wf = self.weight_q(kernel, mode=mode, out="factored")
                w, w_factor = wn, wf.reshape(-1)
            else:
                w = self.weight_q(kernel, mode=mode)
        else:
            w = kernel
            if factored_engine and self.w_factor is not None:
                w_factor = self.w_factor
        if factored_engine:
            return _bf16_exact(x), _bf16_exact(w), w_factor
        return x, w, None

    def _fold(self, w_factor, x_factor):
        """``_fold_values``, or in a prepared layer the (scale, shift) the
        prepare pass stored for the same kind of factors (a weight factor
        or none, an input factor or none)."""
        key = (w_factor is None, x_factor is None)
        if preparing(self):
            scale, shift = self._fold_values(w_factor, x_factor)
            self.prep_fold = torch.stack([scale.expand_as(shift), shift])
            self._prep_fold_key = key
        elif self.prep_fold is None or self._prep_fold_key != key:
            return self._fold_values(w_factor, x_factor)
        return self.prep_fold[0], self.prep_fold[1]

    def _fold_values(self, w_factor, x_factor):
        """(scale, shift) of fixed-mode inference, per output channel:
        ``y*scale + shift == ((y*w_factor)*x_factor)*bn_inv + bn_shift`` (or
        ``+ bias``), with ``scale = (w_factor*x_factor)*bn_inv``.  The bf16
        engine and the kernels' epilogues both take it, so the two differ
        only in summation order.  (The JAX pallas path multiplies
        ``(bn_inv*x_factor)*w_factor``: one rounding apart.)  Under folded
        BN the BN scale is in the weights: ``scale = w_factor*x_factor`` and
        ``shift`` is the folded shift, as in JAX's ``_fixed_scale_shift``
        with ``shift_override``."""
        if self.bn:
            scale, shift = self._bn_inv_shift()
            if self._folded():
                scale = torch.ones_like(scale)
        else:
            scale = torch.ones(self.features, device=self.weight.device)
            shift = self.bias if self.use_bias else torch.zeros_like(scale)
        fac = w_factor
        if x_factor is not None:
            x_factor = x_factor.reshape(())
            fac = x_factor if fac is None else fac * x_factor
        return (scale if fac is None else fac * scale), shift

    def _act_method(self, quant_a):
        return out_quant(self.config, self.act_q, quant_a)

    def _baked(self, quant_w) -> bool:
        return not (quant_w and self.config.quant_w) and self.w_factor is not None

    def _fused_ok(self, mode, train_bn) -> bool:
        """Whether the kernels take this layer (JAX ``_pallas_supported``,
        there lines 268-282): 'fused' in fixed mode, an activation they
        apply, FP8 or symmetric-uniform weights and FP8 or per-tensor
        asymmetric-uniform activations.  Asymmetric weights and symmetric
        or per-channel activations take the bf16 path: JAX sends them to
        its composed path, so that is the reference's route, not a
        fallback that hides a kernel."""
        cfg = self.config
        if not (cfg.engine == "fused" and mode == "fixed" and not train_bn
                and self.activation in FUSED_ACTIVATIONS):
            return False
        if cfg.quant_w and cfg.weight_quant.method not in (
                QMethod.fp_quantizer, QMethod.symmetric_uniform):
            return False
        return not (cfg.quant_a and (
            cfg.act_quant.method not in (QMethod.fp_quantizer,
                                         QMethod.asymmetric_uniform)
            or cfg.act_quant.per_channel))

    # ---- the int8 datapath (JAX nn/layers.py:629-727) ------------------------

    # whether the layer has an int8 route at all (JAX: dense and depthwise
    # convs and linears, there lines 1011-1022)
    int8_capable = True

    def _int8_ok(self, mode, train_bn, quant_w, quant_a) -> bool:
        """JAX ``_int8_xla_ok``: baked int8 weights are taken whatever
        ``quant_w`` is."""
        return (self.int8_capable and int8_datapath(self.config) and quant_a
                and mode == "fixed" and not train_bn
                and (self.w_int8 is not None
                     or (quant_w and self.config.quant_w)))

    def _int8_matrix(self, w: torch.Tensor) -> torch.Tensor:
        """The weight as the int8 kernels' (C, K) matrix."""
        raise NotImplementedError

    def _int8_quant_state(self):
        """(w_delta (C,), signed 0/1 float scalar) of the weight quantizer."""
        spec, st = self.config.weight_quant, self.weight_q.state()
        w_delta = _scale_from_delta(st["delta"], spec.scale_domain, spec.eps)
        w_delta = torch.broadcast_to(w_delta.reshape(-1),
                                     (self.features,)).contiguous()
        return w_delta, st["signed"].to(torch.float32).reshape(())

    def _int8_weight(self):
        """The baked int8 grid, or else the float32 (C, K) weight that the
        route quantizes (JAX ``_int8_weight_state``)."""
        if self.w_int8 is not None:
            return self.w_int8
        return self._operand("int8", lambda w: self._int8_matrix(w)
                             .to(torch.float32).contiguous())

    def _int8_scalars(self):
        """(w_delta (C,), [0, signed, a_delta, a_zero, 0]): the weight's
        step (baked or from its quantizer) and the input quantizer's
        scalars; the prepared ones when there are."""
        if self.prep_int8_scalars is not None and not preparing(self):
            return self.prep_int8_w_delta, self.prep_int8_scalars
        if self.w_int8 is not None:
            w_delta, signed = self.w_delta, self.w_signed
        else:
            w_delta, signed = self._int8_quant_state()
        spec, st = self.config.act_quant, self.act_q.state()
        a_delta = _scale_from_delta(st["delta"].reshape(()), spec.scale_domain,
                                    spec.eps)
        zero = torch.zeros_like(signed)
        scalars = torch.stack([zero, signed, a_delta,
                               st["zero_float"].reshape(()), zero])
        if preparing(self):
            self.prep_int8_w_delta, self.prep_int8_scalars = w_delta, scalars
        return w_delta, scalars

    @torch.no_grad()
    def int8_weights(self):
        """(w_int8, w_delta, w_signed) from the weight quantizer: what the
        int8 bake stores (JAX ``_sow_int8_weights``, without the sow)."""
        w_delta, signed = self._int8_quant_state()
        w = self._int8_matrix(self._kernel().detach()).to(torch.float32)
        return self._int8_grid(w, w_delta, signed), w_delta, signed

    def _int8_grid(self, w, w_delta, signed) -> torch.Tensor:
        """The (C, K) int8 recentred grid of ``w`` (itself when baked)."""
        if w.dtype == torch.int8:
            return w
        return int8_ops.int8_shifted_grid(w, w_delta[:, None], signed,
                                          self.config.weight_quant.n_bits
                                          ).to(torch.int8).contiguous()

    def _int8_args(self):
        """Everything an int8 route needs: the weight, its (w_delta,
        w_scalars) and the input quantizer's (a_delta, a_zero, a_scalars),
        the folded (scale, shift) and the kernels' config fields."""
        w_delta, s = self._int8_scalars()
        scale, shift = self._fold(None, None)
        return dict(
            w=self._int8_weight(), w_delta=w_delta, signed=s[1],
            w_scalars=s[0:2], a_delta=s[2], a_zero=s[3], a_scalars=s[2:5],
            scale=scale.contiguous(), shift=shift.contiguous(),
            kernel_cfg=dict(activation=self.activation,
                            n_bits=self.config.weight_quant.n_bits,
                            act_n_bits=self.config.act_quant.n_bits))

    def _int8_fused(self) -> bool:
        return (self.config.engine == "fused"
                and self.activation in FUSED_ACTIVATIONS)

    def int8_input_grid(self):
        """(delta, zero, bits) of the input quantizer on the int8 datapath
        in fixed mode: the grid a producer puts this layer's operand on
        (``PrequantS8``; JAX's ``out='in_state'`` probe)."""
        s = self._int8_scalars()[1]
        return s[2], s[3], self.config.act_quant.n_bits

    def _int8_matmul(self, x2d, pre: Optional[PrequantS8] = None,
                     emit_s8=None):
        """An (M, K) input through the int8 matmul: float32, or with
        ``pre`` (the ``PrequantS8`` it came in, JAX there lines 1182-1216)
        its int8 operand, whose grid then drives the epilogue.  The kernel
        under ``fused`` where ``autotune.int8_matmul_wins`` says so (an
        int8 operand through its s8 input branch where the branch takes
        its K), ``ops/int8.int8_matmul`` otherwise and under ``emit_s8``
        (JAX nn/layers.py:857, 1187 takes the s8 composed route unraced
        outside ``always``; on the H100 the kernel wins there, so the port
        races it)."""
        a = self._int8_args()
        a_delta, a_zero = ((a["a_delta"], a["a_zero"]) if pre is None
                           else (pre.delta, pre.zero))

        def composed():
            return int8_ops.int8_matmul(
                x2d, self._int8_grid(a["w"], a["w_delta"], a["signed"]),
                a["w_delta"], a["signed"], a_delta, a_zero,
                self.config.act_quant.n_bits, scale=a["scale"],
                shift=a["shift"], act_fn=get_activation(self.activation),
                x_prequant=pre is not None, emit_s8=emit_s8,
                **self._int8_flags())

        if (emit_s8 is not None or not self._int8_fused()
                or (pre is not None
                    and not qmatmul_int8.s8_input_ok(x2d.shape[1]))):
            return composed()
        if pre is None:
            x_op, a_scalars = x2d.to(torch.float32).contiguous(), a["a_scalars"]
        else:
            x_op = x2d.contiguous()
            a_scalars = torch.stack([a_delta, a_zero, torch.zeros_like(a_zero)])

        def kernel():
            y = qmatmul_int8.fused_quant_matmul_int8(
                x_op, a["w"], a["w_delta"], a["w_scalars"], a_scalars,
                a["scale"], a["shift"],
                cfg=qmatmul_int8.Int8MatmulConfig(**a["kernel_cfg"]))
            # stored as the composed route stores it (JAX's pallas engine
            # takes that route here)
            return y.to(torch.bfloat16) if self.config.conv_out_bf16 else y

        return gated_route(
            self, partial(autotune.int8_matmul_wins, x2d.shape[0],
                          x2d.shape[1], self.features, pre is not None,
                          like=x2d), kernel, composed)

    def _int8_flags(self) -> dict:
        """The ops/int8 route's deployment flags (JAX there lines 969-970)."""
        return dict(out_bf16=self.config.conv_out_bf16,
                    signed_static=self.config.int8_assume_signed)

    def _operand(self, kind: str, make):
        """A kernel weight operand derived from ``_kernel()``: in a prepared
        layer the buffer ``prep_op_<kind>`` that the prepare pass stored
        (an exported program holds it as a constant), else rebuilt when the
        weight (or, under folded BN, the BN scale) changes: bake, load,
        device move."""
        name = "prep_op_" + kind
        if not preparing(self) and getattr(self, name, None) is not None:
            return getattr(self, name)
        deps = [self.weight] + ([self.bn_weight, self.running_var]
                                if self._folded() else [])
        key = (kind, self.weight.device,
               tuple((t._version, t.data_ptr()) for t in deps))
        hit = self._operand_cache.get(kind)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, make(self._kernel().detach()))
            self._operand_cache[kind] = hit
        if preparing(self):
            self.register_buffer(name, hit[1])
        return hit[1]

    def _w_kernel_consts(self, w2d, features, mode):
        """(6, N) constants of the weight quantizer for qmatmul's in-kernel
        weight quant: FP8 or int_sym; the prepared ones when there are."""
        if self.prep_w_consts is not None and not preparing(self):
            return self.prep_w_consts
        cfg = self.config
        if cfg.weight_quant.is_fp8:
            _, wst = self.weight_q(w2d, mode=mode, out="state")
            w_c = fp8_consts(torch.broadcast_to(wst["maxval"].reshape(-1),
                                                (features,)),
                             wst["mantissa_bits"], cfg.weight_quant.n_bits,
                             wst["sign_bits"])
        else:
            w_c = int_sym_consts(*self._int8_quant_state(),
                                 cfg.weight_quant.n_bits)
        if preparing(self):
            self.prep_w_consts = w_c
        return w_c

    def _fused_matmul(self, x2d, features, mode, quant_w, quant_a, x_factor,
                      out):
        """The qmatmul kernel route (JAX ``_pallas_forward``) for an (M, K)
        input and its factor (None for a plain tensor).  Under
        ``quantize_input`` the kernel quantizes the input, which forward
        has materialized (see the module docstring)."""
        cfg = self.config
        quant_in = self._quantizes_input(quant_a)
        w2d = self._kernel().reshape(features, -1)
        if quant_w and cfg.quant_w:
            wop, w_factor = w2d.detach().contiguous(), None  # factor in kernel
            w_method = "fp8" if cfg.weight_quant.is_fp8 else "int_sym"
            w_c = self._w_kernel_consts(w2d, features, mode)
        else:
            w_method, w_c = "none", None
            wop = self._operand("matmul", lambda w: w.reshape(features, -1)
                                .to(torch.bfloat16).contiguous())
            w_factor = self.w_factor
        a_method, a_c = self._act_method(quant_a)
        scale, shift = self._fold(w_factor, x_factor)
        emit = (out == "factored" and a_method != "none" and not quant_in
                and factored_act_ok(cfg))
        kcfg = qmatmul.FusedQuantMatmulConfig(
            weight_method=w_method, act_method=a_method,
            quantize_input=cfg.quantize_input, activation=self.activation,
            emit_norm=emit)
        y = qmatmul.fused_quant_matmul(x2d.contiguous(), wop, w_c, a_c,
                                       scale.contiguous(), shift.contiguous(),
                                       cfg=kcfg)
        return Factored(y, a_c[5, 0]) if emit else y


def _bf16_exact(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


class QuantConv(QuantizedLayerBase):
    """Quantized 2-D convolution on NHWC input, optionally BN-fused; dense
    (``groups == 1``), depthwise (``groups == in_features == features``,
    weight (C, 1, k, k)) or grouped (weight (Cout, Cin/groups, k, k), the
    composed path only)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, bn: bool = False,
                 activation: Optional[str] = None, use_bias: bool = False,
                 config: LayerQuantConfig = LayerQuantConfig(),
                 groups: int = 1, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1, s2d=False):
        if s2d not in S2D_MODES:
            raise ValueError(f"s2d must be one of {S2D_MODES}, got {s2d!r}")
        if in_features % groups or features % groups:
            raise ValueError(f"groups {groups} must divide in_features "
                             f"{in_features} and features {features}")
        super().__init__((features, in_features // groups, kernel_size,
                          kernel_size),
                         features, config, activation, bn, use_bias, bn_eps,
                         bn_momentum)
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.groups = groups
        self.s2d = s2d
        self.depthwise = groups != 1 and groups == in_features == features
        # the int8 route: dense or depthwise (the row sum is per group)
        self.int8_capable = groups == 1 or self.depthwise

    def fused_state(self, quant_w: bool, quant_a: bool, x_factor=None):
        """This layer's part of a larger fused kernel (JAX
        ``_conv_fused_state``): the folded (scale, shift) with ``x_factor``
        (the input's factor) folded in, the output quant (``stage_state``)
        and, for a 1x1 or depthwise 3x3 conv, the qblock weight operand
        ``w`` (``block_operand``).  None unless baked, and None under input
        quantization, the int8 datapath, folded BN or quantizers that the
        kernels do not take (``_fused_ok``)."""
        cfg = self.config
        if (cfg.quantize_input or cfg.int8_mxu or self._folded()
                or not self._baked(quant_w)
                or not self._fused_ok("fixed", False)):
            return None
        scale, shift = self._fold(self.w_factor, x_factor)
        return dict(scale=scale, shift=shift, w=self.block_operand(),
                    **stage_state(cfg, self.act_q, quant_a))

    def block_operand(self) -> Optional[torch.Tensor]:
        """The qblock kernel's operand of this baked stage, built once: a
        1x1 conv's (in, out) bf16 matrix, a depthwise 3x3's (3, 3, C)
        float32 taps; None for other convs."""
        if self.depthwise and self.kernel_size == 3:
            return self._operand("dw3x3", qdwconv.weight_taps)
        if self.groups == 1 and self.kernel_size == 1:
            return self._operand("block1x1", lambda w: w.reshape(
                self.features, -1).t().to(torch.bfloat16).contiguous())
        return None

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, train_bn: bool = False,
                out: str = "value"):
        if mode == "fp32":
            mode, quant_w, quant_a = "fixed", False, False
        self._check_train_bn(train_bn)
        # an s2d stem rides the general conv path (JAX nn/layers.py:845-847)
        if not self.s2d and self._int8_ok(mode, train_bn, quant_w, quant_a):
            return self._int8_conv(factored.materialize(x))
        if self._quantizes_input(quant_a):
            x = factored.materialize(x)     # re-quantized, as on parity
        x, x_factor = factored.split(x)
        k, s, p = self.kernel_size, self.stride, self.padding
        n, h, cin = x.shape[0], x.shape[1], x.shape[-1]
        args = (mode, quant_w, quant_a, train_bn, out)

        def composed():
            return self._composed(x, x_factor, *args)

        if self._fused_ok(mode, train_bn) and (self.groups == 1
                                               or self.depthwise):
            # the 3x3 and depthwise kernels take baked weights and quantize
            # outputs only (JAX deploy_ok, there lines 901-903, 987); each
            # kernel sits behind its gate (there lines 857-871, 919-941,
            # 976-991)
            deploy = self._baked(quant_w) and not self.config.quantize_input
            if self.depthwise:
                if (k == 3 and p == 1 and s in (1, 2) and deploy
                        and cin >= 32
                        and (s == 1 or (x.shape[1] % 2 == 0
                                        and x.shape[2] % 2 == 0))):
                    return gated_route(
                        self, partial(autotune.dw_group, n, h, cin, 1,
                                      stride=s, like=x),
                        lambda: self._fused_dwconv3x3(x, quant_a, x_factor,
                                                      out), composed)
                return composed()
            if k == 1 and p == 0:
                xs = x if s == 1 else x[:, ::s, ::s, :]
                return gated_route(
                    self, partial(autotune.pallas_wins,
                                  math.prod(xs.shape[:-1]), cin,
                                  self.features, like=x),
                    lambda: self._fused_1x1(xs, x_factor, *args), composed)
            if (k == 3 and p == 1 and s in (1, 2) and deploy
                    and cin % 8 == 0 and self.features % 8 == 0):
                return gated_route(
                    self, partial(autotune.conv3_group, n, h, cin,
                                  self.features, 1, stride=s, like=x),
                    lambda: self._fused_conv3x3(x, quant_a, x_factor, out),
                    composed)
        return composed()

    def _fused_1x1(self, xs, x_factor, mode, quant_w, quant_a, train_bn, out):
        """A 1x1 conv on ``xs`` (the input, strided) through qmatmul."""
        n, h, w_, c = xs.shape
        y = self._fused_matmul(xs.reshape(-1, c), self.features, mode,
                               quant_w, quant_a, x_factor, out)
        if isinstance(y, Factored):
            return Factored(y.norm.reshape(n, h, w_, -1), y.factor)
        return y.reshape(n, h, w_, -1)

    def _composed(self, x, x_factor, mode, quant_w, quant_a, train_bn, out):
        """The conv off the kernels: the engine's product, the epilogue and
        the output quant."""
        s, p = self.stride, self.padding
        if x_factor is None:
            x, x_factor = self._quant_in_engine(x, mode, quant_a)
        xm, wm, w_factor = self._engine_operands(x, mode, quant_w)
        xm = xm.to(torch.float32)
        if self._s2d_applies(xm):
            # after the weight fake-quant (JAX nn/layers.py:1008-1019): an
            # exact re-indexing, the input padded explicitly because
            # F.conv2d pads symmetrically only
            if self.s2d != "input":
                xm = s2d_ops.space_to_depth(xm)
            w2, (s, _), ((top, bottom), (left, right)) = (
                s2d_ops.s2d_stem_kernel(wm.permute(2, 3, 1, 0)))
            wm = w2.permute(3, 2, 0, 1)
            xm, p = F.pad(xm, (0, 0, left, right, top, bottom)), 0
        # bf16-exact operands are exact in TF32 too (see module docstring)
        with torch.backends.cudnn.flags(
                enabled=True, allow_tf32=self.config.engine != "parity"):
            y = F.conv2d(xm.permute(0, 3, 1, 2), wm, stride=s, padding=p,
                         groups=self.groups)
        y = round_conv_out(self.config, y.permute(0, 2, 3, 1), mode, quant_a,
                           out)
        y = self._affine_epilogue(y, w_factor, x_factor, mode, train_bn)
        return self._quant_out(y, mode, quant_a, out)

    def _s2d_applies(self, x) -> bool:
        """Whether this conv runs as the space-to-depth stem (JAX
        nn/layers.py:1008-1014): a 7x7/2 conv with padding 3 on NHWC input
        that arrives s2d'd (``'input'``) or has even H and W."""
        return (bool(self.s2d) and self.kernel_size == 7 and self.stride == 2
                and self.padding == 3 and self.groups == 1 and x.ndim == 4
                and (self.s2d == "input"
                     or (x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0)))

    def _int8_matrix(self, w):
        return qconv_int8.weight_matrix(w)

    def _int8_conv(self, x):
        """The int8 routes of a conv (x float32 NHWC): qconv_int8, the int8
        matmul for a dense 1x1, ``ops/int8.int8_conv`` for anything else
        (the depthwise convs among them)."""
        k, s, p = self.kernel_size, self.stride, self.padding
        n, h, cin = x.shape[0], x.shape[1], x.shape[-1]
        dense = self.groups == 1
        if self._int8_fused() and dense and k == 1 and p == 0:
            xs = x if s == 1 else x[:, ::s, ::s, :]
            n, h, w_, c = xs.shape
            return self._int8_matmul(xs.reshape(-1, c)).reshape(n, h, w_, -1)
        if (self._int8_fused() and dense and k == 3 and p == 1
                and s in (1, 2) and cin % 16 == 0 and self.features % 16 == 0):
            return gated_route(
                self, partial(autotune.conv3_int8_group, n, h, cin,
                              self.features, 1,
                              prequant=self.w_int8 is not None, stride=s,
                              like=x),
                lambda: self._int8_conv3x3(x), lambda: self._int8_xla(x))
        return self._int8_xla(x)

    def _int8_conv3x3(self, x):
        """The qconv_int8 kernel route."""
        a = self._int8_args()
        return qconv_int8.fused_quant_conv3x3_int8(
            x.to(torch.float32).contiguous(), a["w"], a["w_delta"],
            a["w_scalars"], a["a_scalars"], a["scale"], a["shift"],
            cfg=qconv_int8.Int8ConvConfig(stride=self.stride,
                                          **a["kernel_cfg"]))

    def _int8_xla(self, x):
        """``ops/int8.int8_conv``, the composed s8 route (JAX's XLA-native
        int8 datapath), dense or depthwise."""
        k, s, p = self.kernel_size, self.stride, self.padding
        a = self._int8_args()
        wsg = self._int8_grid(a["w"], a["w_delta"], a["signed"])
        return int8_ops.int8_conv(
            x, wsg.reshape(self.features, k, k, -1).permute(0, 3, 1, 2),
            a["w_delta"], a["signed"], a["a_delta"], a["a_zero"],
            self.config.act_quant.n_bits, stride=s, padding=p,
            scale=a["scale"], shift=a["shift"],
            act_fn=get_activation(self.activation), groups=self.groups,
            **self._int8_flags())

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

    def _fused_dwconv3x3(self, x, quant_a, x_factor, out):
        """The qdwconv3x3 kernel route (JAX ``_pallas_dwconv3x3``)."""
        a_method, a_c = self._act_method(quant_a)
        scale, shift = self._fold(self.w_factor, x_factor)
        emit = (out == "factored" and a_method != "none"
                and factored_act_ok(self.config))
        kcfg = qdwconv.DwConvConfig(act_method=a_method,
                                    activation=self.activation,
                                    emit_norm=emit, stride=self.stride)
        y = qdwconv.fused_quant_dwconv3x3(
            x.to(torch.bfloat16).contiguous(), self.block_operand(), a_c,
            scale.contiguous(), shift.contiguous(), cfg=kcfg)
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

    def _int8_matrix(self, w):
        return w

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, train_bn: bool = False,
                out: str = "value", emit_s8=None):
        """``x``: a tensor, ``Factored`` or ``PrequantS8`` (the operand on
        this layer's input grid, taken as it is by the int8 route and
        materialized elsewhere).  ``emit_s8``: (delta, zero, bits) of the
        next consumer's input grid; the int8 route then returns a
        ``PrequantS8`` (any other route raises)."""
        if mode == "fp32":
            mode, quant_w, quant_a = "fixed", False, False
        self._check_train_bn(train_bn)
        if self._int8_ok(mode, train_bn, quant_w, quant_a):
            pre = x if isinstance(x, PrequantS8) else None
            xv = factored.materialize(x) if pre is None else pre.xs8
            y = self._int8_matmul(xv.reshape(-1, xv.shape[-1]), pre, emit_s8)
            y = y.reshape(*xv.shape[:-1], -1)
            return y if emit_s8 is None else PrequantS8(y, *emit_s8)
        if emit_s8 is not None:
            raise ValueError("emit_s8 needs the int8 datapath in fixed mode "
                             "with quantized (or int8-baked) weights")
        if self._quantizes_input(quant_a):
            x = factored.materialize(x)     # re-quantized, as on parity
        x, x_factor = factored.split(x)
        args = (mode, quant_w, quant_a, train_bn, out)

        def composed():
            return self._composed(x, x_factor, *args)

        if self._fused_ok(mode, train_bn):
            return gated_route(
                self, partial(autotune.pallas_wins, math.prod(x.shape[:-1]),
                              x.shape[-1], self.features, like=x),
                lambda: self._fused_linear(x, x_factor, *args), composed)
        return composed()

    def _fused_linear(self, x, x_factor, mode, quant_w, quant_a, train_bn,
                      out):
        """The layer through qmatmul (JAX there lines 1222-1233)."""
        lead = x.shape[:-1]
        y = self._fused_matmul(x.reshape(-1, x.shape[-1]), self.features,
                               mode, quant_w, quant_a, x_factor, out)
        if isinstance(y, Factored):
            return Factored(y.norm.reshape(*lead, -1), y.factor)
        return y.reshape(*lead, -1)

    def _composed(self, x, x_factor, mode, quant_w, quant_a, train_bn, out):
        """The layer off the kernels: the engine's product, the epilogue and
        the output quant."""
        if x_factor is None:
            x, x_factor = self._quant_in_engine(x, mode, quant_a)
        xm, wm, w_factor = self._engine_operands(x, mode, quant_w)
        y = round_conv_out(self.config, xm.to(torch.float32) @ wm.t(), mode,
                           quant_a, out)
        y = self._affine_epilogue(y, w_factor, x_factor, mode, train_bn)
        return self._quant_out(y, mode, quant_a, out)


def _same_pads(size: int, k: int, s: int):
    """(lo, hi) of XLA's 'SAME' padding for one dimension."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class QuantConv1d(QuantizedLayerBase):
    """Quantized 1-D convolution on NWC input, optionally BN-fused (JAX
    ``QuantConv1d``, there lines 1032-1080): weight (features,
    in_features/groups, kernel_size); ``padding`` an int (both sides), a
    (lo, hi) pair or 'SAME' / 'VALID'.  The composed path on every
    engine."""

    int8_capable = False

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding=0, bn: bool = False,
                 activation: Optional[str] = None, use_bias: bool = True,
                 config: LayerQuantConfig = LayerQuantConfig(),
                 groups: int = 1, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1):
        if in_features % groups or features % groups:
            raise ValueError(f"groups {groups} must divide in_features "
                             f"{in_features} and features {features}")
        # a bias only without BN, as JAX creates it
        super().__init__((features, in_features // groups, kernel_size),
                         features, config, activation, bn, use_bias and not bn,
                         bn_eps, bn_momentum)
        self.kernel_size, self.stride, self.groups = kernel_size, stride, groups
        self.padding = padding

    def _pads(self, size: int):
        p = self.padding
        if p == "SAME":
            return _same_pads(size, self.kernel_size, self.stride)
        if p == "VALID":
            return 0, 0
        return (p, p) if isinstance(p, int) else tuple(p)

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, train_bn: bool = False,
                out: str = "value"):
        if mode == "fp32":
            mode, quant_w, quant_a = "fixed", False, False
        self._check_train_bn(train_bn)
        if self._quantizes_input(quant_a):
            x = factored.materialize(x)     # re-quantized, as on parity
        x, x_factor = factored.split(x)
        if x_factor is None:
            x, x_factor = self._quant_in_engine(x, mode, quant_a)
        xm, wm, w_factor = self._engine_operands(x, mode, quant_w)
        xm = F.pad(xm.to(torch.float32).transpose(1, 2),
                   self._pads(xm.shape[1]))
        with torch.backends.cudnn.flags(
                enabled=True, allow_tf32=self.config.engine != "parity"):
            y = F.conv1d(xm, wm, stride=self.stride, groups=self.groups)
        y = round_conv_out(self.config, y.transpose(1, 2), mode, quant_a, out)
        y = self._affine_epilogue(y, w_factor, x_factor, mode, train_bn)
        return self._quant_out(y, mode, quant_a, out)


def conv_transpose_pads(k: int, s: int, padding):
    """(lo, hi) padding of the stride-1 conv over the stride-dilated input
    that ``jax.lax.conv_transpose`` runs for one dimension (kernel not
    flipped, its ``_conv_transpose_padding``): 'SAME', 'VALID' or an
    explicit (lo, hi) pair, taken as it is."""
    if padding == "SAME":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len, lo = k + s - 2 + max(k - s, 0), k - 1
    else:
        return tuple(padding)
    return lo, pad_len - lo


class QuantConvTranspose(QuantizedLayerBase):
    """Quantized N-D transposed convolution on channel-last input (JAX
    ``QuantConvTranspose``, there lines 1083-1130: ``lax.conv_transpose``
    with its default unflipped kernel), no BN: weight (features,
    in_features, *kernel_size), the output channel first as in every layer
    here; ``padding`` 'SAME', 'VALID' or one (lo, hi) pair a dimension in
    JAX's sense (``conv_transpose_pads``), not torch's.  Torch's transposed
    convolution at padding 0 is JAX's at padding k - 1 on each side with
    the kernel flipped; JAX's padding then crops (or zero-extends) that
    output side by side.  The composed path on every engine."""

    int8_capable = False

    def __init__(self, in_features: int, features: int,
                 kernel_size=(3, 3), stride=None, padding="SAME",
                 activation: Optional[str] = None, use_bias: bool = True,
                 config: LayerQuantConfig = LayerQuantConfig()):
        kernel_size = tuple(kernel_size)
        if not 1 <= len(kernel_size) <= 3:
            raise ValueError(f"1 to 3 spatial dimensions, got {kernel_size}")
        super().__init__((features, in_features, *kernel_size), features,
                         config, activation, False, use_bias, 1e-5, 0.1)
        self.kernel_size = kernel_size
        self.stride = tuple(stride or (1,) * len(kernel_size))
        self.padding = padding

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, train_bn: bool = False,
                out: str = "value"):
        if mode == "fp32":
            mode, quant_w, quant_a = "fixed", False, False
        if self._quantizes_input(quant_a):
            x = factored.materialize(x)     # re-quantized, as on parity
        x, x_factor = factored.split(x)
        if x_factor is None:
            x, x_factor = self._quant_in_engine(x, mode, quant_a)
        xm, wm, w_factor = self._engine_operands(x, mode, quant_w)
        nd = len(self.kernel_size)
        spatial = tuple(range(2, 2 + nd))
        conv = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[nd - 1]
        with torch.backends.cudnn.flags(
                enabled=True, allow_tf32=self.config.engine != "parity"):
            y = conv(xm.to(torch.float32).movedim(-1, 1),
                     wm.flip(spatial).transpose(0, 1), stride=self.stride)
        pads = [conv_transpose_pads(k, s, self.padding if isinstance(
            self.padding, str) else self.padding[i])
                for i, (k, s) in enumerate(zip(self.kernel_size, self.stride))]
        crop = []
        for (lo, hi), k in zip(reversed(pads), reversed(self.kernel_size)):
            crop += [lo - (k - 1), hi - (k - 1)]
        y = F.pad(y, crop).movedim(1, -1)
        y = round_conv_out(self.config, y, mode, quant_a, out)
        y = self._affine_epilogue(y, w_factor, x_factor, mode, train_bn)
        return self._quant_out(y, mode, quant_a, out)


class QuantLayerNorm(nn.Module):
    """Quantized LayerNorm over the last axis (JAX ``QuantLayerNorm``, there
    lines 1249-1282): gamma (``weight``, JAX ``scale``) is fake-quantized as
    the layer's weight, per channel when the config says so (each of the
    ``features`` elements is its own channel, as JAX's ``channel_axis=-1``
    on a 1-D parameter), at full scale on every engine (JAX ``_quant_w``:
    no factored weight, so the bake stores the fake-quant gamma and no
    ``w_factor``).  The normalization is float32 on the materialized input,
    ``(x - mean) * rsqrt(var + eps) * gamma + beta`` with JAX's mean and
    variance (sums divided by the count), then the output quant
    (``Factored`` under ``out='factored'`` on bf16/fused)."""

    def __init__(self, features: int,
                 config: LayerQuantConfig = LayerQuantConfig(),
                 epsilon: float = 1e-5):
        super().__init__()
        self.config, self.epsilon = config, epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.weight_q = Quantizer(
            config.weight_quant, config.weight_range,
            num_channels=features if config.weight_quant.per_channel else None,
            channel_axis=0, reduce_over_batch=False)
        self.act_q = Quantizer(config.act_quant, config.act_range)

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, out: str = "value", emit_s8=None):
        """``emit_s8``: (delta, zero, bits) of the consumer's input grid;
        the output is then that ``PrequantS8``, made before this layer's
        own output quant (JAX there lines 1275-1281)."""
        if mode == "fp32":
            mode, quant_w, quant_a = "fixed", False, False
        x = factored.materialize(x).to(torch.float32)
        if self.config.quantize_input and quant_a and self.config.quant_a:
            x = self.act_q(x, mode=mode)
        w = self.weight
        if quant_w and self.config.quant_w:
            w = self.weight_q(w, mode=mode)
        n = x.shape[-1]
        mean = x.sum(dim=-1, keepdim=True) / n
        xc = x - mean
        var = (xc * xc).sum(dim=-1, keepdim=True) / n
        y = xc * torch.rsqrt(var + self.epsilon) * w + self.bias
        if emit_s8 is not None:
            return PrequantS8(int8_ops.prequant_s8(y, *emit_s8), *emit_s8)
        return quant_output(self.config, self.act_q, y, mode, quant_a, out)


class QuantizedActivation(nn.Module):
    """Standalone activation quantizer (e.g. after a residual add)."""

    def __init__(self, config: LayerQuantConfig = LayerQuantConfig()):
        super().__init__()
        self.config = config
        self.act_q = Quantizer(config.act_quant, config.act_range)

    def fused_state(self, quant_a: bool) -> dict:
        """The fixed-mode output quant of a fused kernel's last stage (JAX
        ``out='fused_state'``): ``stage_state``."""
        return stage_state(self.config, self.act_q, quant_a)

    def forward(self, x, mode: str = "fixed", quant_a: bool = True,
                update_range: bool = True, out: str = "value"):
        x = factored.materialize(x)
        if mode != "fp32" and quant_a and self.config.quant_a:
            if out == "factored" and factored_act_ok(self.config):
                norm, factor = self.act_q(x, mode=mode,
                                          update_range=update_range,
                                          out="factored")
                return Factored(factored.storage_dtype(norm), factor)
            return self.act_q(x, mode=mode, update_range=update_range)
        return x

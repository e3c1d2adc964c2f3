"""Serving export: the calibrated quantized model as one ``torch.export``
artifact.

Mirrors ``fp8_quantization_tpu/serving/export.py``.  The JAX package
serializes the jitted fixed-mode forward to StableHLO with its Pallas
kernels inside; here ``torch.export`` records the prepared fixed-mode
forward as an ATen graph whose kernel calls are the ``fp8tpu::*`` ops
(ops/kernels/library.py), with the baked weights, the prepared constants
and the kernels' weight operands held as the program's constants, and
``torch.export.save`` writes it, with the one setting that a program
cannot record beside it: whether the composed convolutions allow TF32
(they set it around each call; under other flags cuDNN picks other
algorithms).  A server loads it with ``load_exported`` and calls it: no
model code, configs or calibration data at serving time
(``load_exported`` imports neither ``models`` nor ``nn.layers``).  What it
needs is this package's op library, which launches the kernels built from
``csrc/`` (ops/kernels/build.py builds them at the first launch), on a
card of the kind the program was exported for.

Differences from JAX: the model holds its own variables, so there is no
``variables`` argument; the ``bf16`` and ``fused`` engines run the prepare
pass (nn/bake.prepare_inference) first where it has not run; and the
input shape returned has ``None`` for a symbolic batch.
"""

from __future__ import annotations

import json
import logging
from typing import Optional, Tuple

import torch
from torch import nn

from fp8_quantization_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)

EXAMPLE_BATCH = 2       # the symbolic batch's example: a batch of 1 would
                        # specialize the trace to it
SETTINGS = "fp8tpu_settings.json"   # the artifact's extra file: what the
                                    # program cannot hold (``conv_tf32``)


class _Fixed(nn.Module):
    """``model(x, mode='fixed', quant_w=...)`` as a one-argument module."""

    def __init__(self, model: nn.Module, quant_w: bool):
        super().__init__()
        self.model, self.quant_w = model, quant_w

    def forward(self, x):
        return self.model(x, mode="fixed", quant_w=self.quant_w)


def conv_tf32(model: nn.Module) -> bool:
    """Whether the cuDNN convolutions of the model's fixed-mode forward
    allow TF32, as each sets it around its call: a layer's composed
    convolution does on every engine but 'parity' (nn/layers.py
    ``QuantConv._composed``), the int8 datapath's never (ops/int8.int8_conv;
    its space-to-depth stem takes the composed route).  A program cannot
    record the setting, so the artifact carries it (one for the model)."""
    from fp8_quantization_tpu_torch.nn.layers import QuantConv, int8_datapath

    tf32 = {m.config.engine != "parity"
            and not (int8_datapath(m.config) and not m.s2d)
            for m in model.modules() if isinstance(m, QuantConv)}
    if len(tf32) > 1:
        raise ValueError("export: the model's convolutions take different "
                         "TF32 settings (the int8 datapath with a "
                         "space-to-depth stem, or the 'parity' engine mixed "
                         "with others), which one program cannot hold")
    return tf32.pop() if tf32 else False


def _read_constants_in_place(program) -> None:
    """Let the program read its lifted constants instead of copying them on
    every forward.  ``torch.export`` records a tensor made from a host
    value (``torch.tensor(eps, device=...)`` in ops/uniform.py, the
    quantizers' bounds) as a constant and a ``lift_fresh_copy`` of it (then
    ``detach_`` for ``torch.tensor``), one device copy a forward; where no
    user of the copy writes to it, the constant itself serves."""
    from torch.export.graph_signature import InputKind

    constants = {spec.arg.name for spec in program.graph_signature.input_specs
                 if spec.kind == InputKind.CONSTANT_TENSOR}
    detach = (torch.ops.aten.detach_.default, torch.ops.aten.detach.default)

    def writes(node):
        return (node.target not in detach
                and getattr(node.target, "_schema", None) is not None
                and node.target._schema.is_mutable)

    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if not (node.op == "call_function"
                and node.target is torch.ops.aten.lift_fresh_copy.default
                and node.args[0].name in constants):
            continue
        users = [node] + [u for u in node.users if u.target in detach]
        if any(writes(u) for v in users for u in v.users):
            continue
        for v in reversed(users):
            v.replace_all_uses_with(node.args[0])
            graph.erase_node(v)
    program.graph_module.recompile()


def conv_flags(allow_tf32: bool):
    """The cuDNN settings that a loaded artifact runs under: those that the
    live model's composed convolutions set around each call (``conv_tf32``
    of the model).  Convolutions outside the layers (ops/int8's) take them
    too, where live they take the caller's."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=allow_tf32)


def export_quantized_model(model: nn.Module, path: str, *,
                           batch_size: Optional[int] = None,
                           image_size: int = 224, channels: int = 3,
                           bake: bool = True, quant_w: Optional[bool] = None,
                           device=None) -> Tuple[str, tuple]:
    """Serialize ``model(x, mode='fixed', quant_w=...)`` to ``path``.

    ``batch_size=None`` exports a symbolic batch (``torch.export.Dim``),
    traced at an example batch of ``EXAMPLE_BATCH``, so that one artifact
    serves any batch.  ``bake=True`` first bakes the calibrated model in
    place as the CLI's ``--bake-weights`` does (nn/bake.bake_for_inference:
    the int8 grid under the int8 datapath, else the fake-quant weights and
    ``quant_w=False``); pass ``quant_w=False`` for a model already baked
    (and prepared, nn/bake.prepare_for_deployment) to export it as it
    stands.  On the ``bf16`` and ``fused`` engines the prepare pass runs
    first unless it has run.  ``device``: where the export runs (the model
    is moved there), by default the model's own.

    The gated kernel sites (ops/kernels/autotune.py) take the routes of
    one real forward at the example batch, run before the trace (under
    ``auto`` its first sight of a shape races there), recorded and
    replayed while tracing (nn/layers.route_log) and logged in one line:
    the routes of a polymorphic artifact are those of its example batch,
    whatever batch it later serves.

    Returns ``(path, input shape)``, the shape in the geometry the model
    takes (``model.input_shape``), ``None`` for a symbolic batch.
    """
    from fp8_quantization_tpu_torch.nn.bake import (
        bake_for_inference, is_prepared, prepare_inference)
    from fp8_quantization_tpu_torch.nn.layers import route_log

    device = (next(model.parameters()).device if device is None
              else resolve_device(device))
    model.to(device).eval()
    if quant_w is None:
        quant_w = bake_for_inference(model) if bake else True
    if model.config.engine in ("bf16", "fused") and not is_prepared(model):
        prepare_inference(model, torch.zeros(
            model.input_shape((1, image_size, image_size, channels)),
            device=device), quant_w=quant_w)
    batch = EXAMPLE_BATCH if batch_size is None else batch_size
    shape = model.input_shape((batch, image_size, image_size, channels))
    example = torch.zeros(shape, device=device)
    for m in model.modules():
        m.__dict__.pop("_export_route", None)
    fixed = _Fixed(model, quant_w)
    with torch.no_grad():
        with route_log(model, "record"):
            fixed(example)
        routes = {name or "<model>": m._export_route
                  for name, m in model.named_modules()
                  if "_export_route" in m.__dict__}
        log.info("export routes (at batch %d; True = the kernel): %s", batch,
                 routes)
        dynamic = None
        if batch_size is None:
            dynamic = ({0: torch.export.Dim("batch", min=1)},)
        with route_log(model, "replay"):
            program = torch.export.export(fixed, (example,),
                                          dynamic_shapes=dynamic,
                                          strict=False)
    _read_constants_in_place(program)
    # the example input would be saved with the program (37 MB at batch 64
    # of 224x224 images)
    program.example_inputs = None
    torch.export.save(program, path, extra_files={
        SETTINGS: json.dumps({"cudnn_allow_tf32": conv_tf32(model)})})
    return path, (None if batch_size is None else batch,) + tuple(shape[1:])


def load_exported(path: str, device="cuda"):
    """Load an artifact of ``export_quantized_model``; returns a callable
    ``fn(x) -> logits`` on ``device`` (the card unless the caller asks for
    the CPU), which runs the program under the cuDNN settings the live
    model's convolutions set around each call.  It imports the kernels' op
    library and no model code."""
    from torch.export.passes import move_to_device_pass

    from fp8_quantization_tpu_torch.ops.kernels import library  # noqa: F401

    device = resolve_device(device)
    extra = {SETTINGS: ""}
    program = torch.export.load(path, extra_files=extra)
    # moved only from another device: the pass would also move the CPU
    # scalars that the traced code keeps on the host, each of which would
    # then cost a copy launch a forward
    source = next(iter(program.state_dict.values())).device
    if source != device and not (source.type == device.type == "cuda"
                                 and device.index is None):
        program = move_to_device_pass(program, {str(source): str(device)})
    module = program.module()
    tf32 = json.loads(extra[SETTINGS])["cudnn_allow_tf32"]

    def fn(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), conv_flags(tf32):
            return module(x)
    return fn

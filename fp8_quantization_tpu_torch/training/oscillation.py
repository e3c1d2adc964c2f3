"""Oscillation dampening and freezing for QAT (Nagel et al., "Overcoming
Oscillations in Quantization-Aware Training", ICML 2022).

Mirrors ``fp8_quantization_tpu/training/oscillation.py``, walking the
port's quantized layers (every ``QuantConv`` / ``QuantLinear`` whose
config quantizes its weight, by module path) where JAX walks the
``kernel`` leaves of its parameter tree:

* dampening: ``lambda(t) * sum((detach(Q(w)) - w)^2)`` over the quantized
  weights, ``lambda`` annealed by a cosine from ``dampen_weight`` to
  ``dampen_weight_final`` from ``dampen_anneal_start`` of training;
* freezing: each weight's oscillation frequency (a change of its quantized
  value that reverses the direction of the previous change) is tracked as
  an EMA; a weight whose frequency exceeds the annealed threshold is
  frozen at its latent value for the rest of training.

Weights are quantized with the layer's own weight spec, or a resolver
``path -> QuantizerSpec`` (the models' ``weight_spec_fn``), per channel
along dim 0 (OIHW / (out, in)), with the quantizer's state detached.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from fp8_quantization_tpu_torch.nn.layers import QuantizedLayerBase
from fp8_quantization_tpu_torch.ops import quantizer as q
from fp8_quantization_tpu_torch.ops.quantizer import QuantizerSpec

SpecLike = Union[QuantizerSpec, Callable[[Tuple[str, ...]], QuantizerSpec]]


def _spec_at(spec: SpecLike, path: Tuple[str, ...]) -> QuantizerSpec:
    return spec(path) if callable(spec) else spec


@dataclasses.dataclass(frozen=True)
class OscillationConfig:
    """The ``--oscillations-*`` flags."""

    dampen_weight: float = 0.0             # 0 -> dampening off
    dampen_weight_final: Optional[float] = None
    dampen_anneal_start: float = 0.25      # fraction of total_steps
    freeze_threshold: float = 0.0          # 0 -> freezing off
    freeze_threshold_final: Optional[float] = None
    freeze_anneal_start: float = 0.25
    freeze_ema_momentum: float = 0.99
    total_steps: int = 1000

    @property
    def dampen(self) -> bool:
        return self.dampen_weight > 0

    @property
    def freeze(self) -> bool:
        return self.freeze_threshold > 0


def _anneal(start_val, final_val, step: int, total: int,
            anneal_start: float) -> torch.Tensor:
    """Cosine anneal start -> final over [anneal_start * total, total], a
    float32 scalar computed as JAX computes it."""
    f32 = dict(dtype=torch.float32)
    if final_val is None:
        return torch.tensor(start_val, **f32)
    t0 = anneal_start * total
    frac = torch.clamp((torch.tensor(step, **f32) - t0)
                       / torch.tensor(max(total - t0, 1), **f32), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * (1 - frac)))
    return start_val + (final_val - start_val) * cos


def quantized_layers(model: nn.Module):
    """(path, layer) of every layer whose weight is quantized."""
    for name, m in model.named_modules():
        if isinstance(m, QuantizedLayerBase) and m.config.quant_w:
            yield tuple(name.split(".")), m


def _weight_q(spec: SpecLike, path, layer, w, qstate=None) -> torch.Tensor:
    return q.apply(_spec_at(spec, path), qstate or layer.weight_q.state(), w,
                   channel_axis=0)


def dampening_loss(model: nn.Module, spec: SpecLike) -> torch.Tensor:
    """``sum((detach(Q(w)) - w)^2)`` over every quantized weight element (a
    sum, not a mean: each weight's pull ``2 * lambda * (w - Q(w))`` does not
    depend on its layer's size)."""
    total = None
    for path, layer in quantized_layers(model):
        wq = _weight_q(spec, path, layer, layer.weight)
        term = torch.sum((wq.detach() - layer.weight) ** 2)
        total = term if total is None else total + term
    return total


@torch.no_grad()
def init_osc_state(model: nn.Module, spec: SpecLike) -> Dict[str, dict]:
    """Per layer (by module path): the previous quantized weight, the
    direction of its last change, the oscillation-frequency EMA, the
    frozen mask and the frozen values."""
    state = {}
    for path, layer in quantized_layers(model):
        w = layer.weight.detach()
        state[".".join(path)] = {
            "prev_q": _weight_q(spec, path, layer, w),
            "prev_dir": torch.zeros_like(w), "freq": torch.zeros_like(w),
            "frozen": torch.zeros(w.shape, dtype=torch.bool, device=w.device),
            "frozen_val": torch.zeros_like(w)}
    return state


@torch.no_grad()
def apply_freezing(model: nn.Module, osc_state: Dict[str, dict],
                   spec: SpecLike, step: int, cfg: OscillationConfig,
                   quant_states: Optional[Dict[str, dict]] = None) -> Dict:
    """The freezing pass after the optimizer's update, in place on the
    weights and ``osc_state``; returns ``{"frozen_fraction": ...}``.
    ``quant_states`` (by layer path) are the weight quantizers' states
    before the step's update (JAX freezes against those), the current ones
    when None."""
    thresh = _anneal(cfg.freeze_threshold, cfg.freeze_threshold_final,
                     step, cfg.total_steps, cfg.freeze_anneal_start)
    m = cfg.freeze_ema_momentum
    n_frozen, n_total = 0.0, 0
    for path, layer in quantized_layers(model):
        key = ".".join(path)
        st = osc_state[key]
        thresh_d = thresh.to(layer.weight.device)
        # restore frozen latents first (the optimizer may have moved them)
        w = torch.where(st["frozen"], st["frozen_val"], layer.weight)
        wq = _weight_q(spec, path, layer, w,
                       None if quant_states is None else quant_states[key])
        changed = wq != st["prev_q"]
        direction = torch.sign(wq - st["prev_q"])
        osc = changed & (direction == -st["prev_dir"]) & (st["prev_dir"] != 0)
        freq = m * st["freq"] + (1 - m) * osc.to(torch.float32)
        newly_frozen = (freq > thresh_d) & ~st["frozen"]
        frozen = st["frozen"] | newly_frozen
        frozen_val = torch.where(newly_frozen, w, st["frozen_val"])
        layer.weight.copy_(torch.where(frozen, frozen_val, w))
        st.update(prev_q=wq,
                  prev_dir=torch.where(changed, direction, st["prev_dir"]),
                  freq=freq, frozen=frozen, frozen_val=frozen_val)
        n_frozen += float(frozen.sum())
        n_total += w.numel()
    return {"frozen_fraction": n_frozen / max(n_total, 1)}

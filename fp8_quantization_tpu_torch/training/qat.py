"""Quantization-aware training (QAT): SGD / Adam with a learning-rate
schedule, a separate optimizer for the quantizers' learned ranges, the
``learn`` and ``calibrate_train`` modes, oscillation dampening and
freezing, and BN re-estimation.

Mirrors ``fp8_quantization_tpu/training/qat.py``:

* ``make_schedule`` gives optax's float32 learning rate at every step
  (``multistep:<epoch>:...`` decays 10x at the listed epochs,
  ``cosine:<eta_min>`` anneals to an absolute final rate over
  ``max_steps``); the optimizers take it as a function of the step, not
  through torch's epoch schedulers.
* ``make_optimizer`` describes ``torch.optim.SGD`` (momentum) or ``Adam``;
  weight decay is added to the gradient before momentum, as
  ``optax.chain(add_decayed_weights, sgd)`` does.
* ``quant_trainable_mask`` picks the quantizer state that learns (JAX's
  mask over the ``quant`` tree: ``trainable_param_names`` of the base
  config's weight and act specs, for each live ``weight_q`` / ``act_q``);
  ``init_qat_state`` turns exactly those into parameters
  (nn/quantizers.py ``make_range_trainable``), so the model optimizer takes
  every other parameter and the quant optimizer these.
* ``make_train_step``: forward on the composed engines (``parity`` /
  ``bf16``; under ``fused`` the layers take the bf16 route outside fixed
  mode, as JAX's ``pallas`` engine does), cross-entropy (plus the annealed
  dampening loss), backward, the model optimizer, freezing, the quant
  optimizer.  In ``learn`` mode the ranges learn through the gradient
  estimator; in ``calibrate_train`` the quantizers re-estimate their
  ranges on every forward and the quant optimizer's update is dropped, as
  JAX overwrites it with the re-estimated state.  A parameter that gets no
  gradient takes a zero one, as in JAX (weight decay still moves it).
  Stochastic rounding and dropout draw from generators seeded from the
  step (17 and 23 with the step, as JAX folds the step into those keys),
  never from the global random state.
* Data-parallel training (parallel/api.shard_qat_state sets the state's
  ``mesh``): each rank steps on its rows of the global batch; BN's
  batch statistics are taken over the data group (nn/layers.py), and the
  gradients of both optimizers' parameters, the learned ranges included,
  are averaged over it in one all-reduce before either optimizer steps,
  so every rank takes the same step.  BN's sum passes each rank the
  gradient of all ranks' losses, and the average over ranks then gives
  the gradient of the global batch's mean loss, as one process takes it.
  An explicit all-reduce, not DDP: the step has two optimizers, freezes
  weights between them and gives a parameter without a gradient a zero
  one, and one flat all-reduce after the backward is all it needs.  The
  loss and accuracy are the ranks' mean.  The
  stochastic rounding and dropout streams are seeded alike in every rank,
  and each rank takes its rows of the noise drawn at the global batch
  (parallel/collectives.rand_rows), so the ranks round and drop as one
  process does.  Under tensor parallelism the forward, the
  backward and freezing run on the gathered weights, and the optimizers
  step on each rank's slices (parallel/api.shard_qat_state).
* ``reestimate_bn_stats`` replaces every BN's running statistics by the
  mean over batches of each batch's own (JAX recovers them by algebra over
  the momentum update; here the momentum is set to 1 for the pass, which
  stores them directly).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fp8_quantization_tpu_torch.nn.config import LayerQuantConfig
from fp8_quantization_tpu_torch.nn.layers import QuantizedLayerBase
from fp8_quantization_tpu_torch.nn.quantizers import Quantizer, set_quant_noise
from fp8_quantization_tpu_torch.ops.quantizer import trainable_param_names
from fp8_quantization_tpu_torch.parallel import collectives
from fp8_quantization_tpu_torch.parallel.api import gather_weights
from fp8_quantization_tpu_torch.training.oscillation import (
    OscillationConfig, _anneal, apply_freezing, dampening_loss,
    init_osc_state, quantized_layers)

# the seeds JAX folds the step into (training/qat.py make_train_step)
QUANT_NOISE_SEED, DROPOUT_SEED = 17, 23


# ---- learning rate and optimizers --------------------------------------------

def make_schedule(learning_rate: float, scheduler: Optional[str] = None,
                  max_steps: int = 0, steps_per_epoch: int = 1):
    """``learning_rate`` itself without a scheduler, else a function of the
    step giving optax's float32 value: ``multistep:10:20`` (10x decays at
    those epochs, ``steps_per_epoch`` steps each), ``cosine:<eta_min>``
    (to the absolute ``eta_min`` over ``max_steps``)."""
    if not scheduler:
        return learning_rate
    kind, *opts = scheduler.split(":")
    opts = [o for o in opts if o]
    f32 = dict(dtype=torch.float32)
    if kind == "multistep":
        milestones = sorted({int(o) * max(steps_per_epoch, 1) for o in opts})

        def multistep(step: int) -> float:
            v = torch.tensor(learning_rate, **f32)
            for m in milestones:
                ind = torch.clamp(torch.sign(torch.tensor(float(m - step), **f32)),
                                  min=0.0)
                v = v * ind + (1 - ind) * 0.1 * v
            return float(v)
        return multistep
    if kind == "cosine":
        eta_min = float(opts[0]) if opts else 0.0
        alpha = eta_min / learning_rate if learning_rate else 0.0
        decay_steps = float(max(max_steps, 1))

        def cosine(step: int) -> float:
            count = torch.clamp(torch.tensor(float(step), **f32), max=decay_steps)
            decay = 0.5 * (1 + torch.cos(math.pi * count / decay_steps))
            return float(learning_rate * ((1 - alpha) * decay + alpha))
        return cosine
    raise ValueError(f"unknown scheduler {scheduler}")


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """An optimizer not yet bound to parameters (JAX's optax transform)."""

    name: str
    lr: object                  # a float or a function of the step
    momentum: float = 0.9
    weight_decay: float = 0.0

    def lr_at(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)

    def build(self, params: List[nn.Parameter]) -> torch.optim.Optimizer:
        if self.name.lower() == "sgd":
            return torch.optim.SGD(params, lr=self.lr_at(0),
                                   momentum=self.momentum,
                                   weight_decay=self.weight_decay)
        return torch.optim.Adam(params, lr=self.lr_at(0), betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=self.weight_decay)


def make_optimizer(name: str = "SGD", learning_rate: float = 1e-3,
                   momentum: float = 0.9, weight_decay: float = 0.0,
                   scheduler: Optional[str] = None, max_steps: int = 0,
                   steps_per_epoch: int = 1) -> OptimizerSpec:
    """SGD (with ``momentum``) or Adam, with an optional schedule."""
    if name.lower() not in ("sgd", "adam"):
        raise ValueError(f"unknown optimizer {name}")
    return OptimizerSpec(name, make_schedule(
        learning_rate, scheduler, max_steps=max_steps,
        steps_per_epoch=steps_per_epoch), momentum, weight_decay)


# ---- the quant-parameter split -------------------------------------------------

_QUANTIZER_NAMES = ("weight_q", "act_q")


def quant_trainable_mask(model: nn.Module,
                         config: LayerQuantConfig) -> Dict[str, tuple]:
    """{quantizer path: the state names that learn}: for every ``weight_q``
    of a layer that quantizes its weight and every ``act_q`` of one that
    quantizes activations (the quantizers JAX creates),
    ``trainable_param_names`` of the base config's weight or act spec."""
    allowed = {"weight_q": trainable_param_names(config.weight_quant),
               "act_q": trainable_param_names(config.act_quant)}
    mask = {}
    for name, mod in model.named_modules():
        for qname in _QUANTIZER_NAMES:
            qz = getattr(mod, qname, None)
            cfg = getattr(mod, "config", None)
            if not isinstance(qz, Quantizer) or cfg is None:
                continue
            live = cfg.quant_w if qname == "weight_q" else cfg.quant_a
            if live and allowed[qname]:
                mask[f"{name}.{qname}" if name else qname] = allowed[qname]
    return mask


def partition_quant(model: nn.Module):
    """(model parameters, quant parameters): the quantizers' trainable
    state apart from everything else."""
    quant_ids = {id(p) for m in model.modules() if isinstance(m, Quantizer)
                 for p in m.parameters(recurse=False)}
    params = [p for p in model.parameters() if id(p) not in quant_ids]
    quant = [p for p in model.parameters() if id(p) in quant_ids]
    return params, quant


# ---- train state and step ------------------------------------------------------

@dataclasses.dataclass
class QATState:
    """The model and what training carries with it."""

    model: nn.Module
    model_tx: OptimizerSpec
    quant_tx: OptimizerSpec
    optimizer: torch.optim.Optimizer
    quant_optimizer: Optional[torch.optim.Optimizer]
    oscillation: Optional[OscillationConfig] = None
    weight_spec: object = None
    osc_state: Optional[dict] = None
    step: int = 0
    # the mesh of a data- or tensor-parallel run (parallel/api.shard_qat_state)
    mesh: object = None


def init_qat_state(model: nn.Module, config: LayerQuantConfig,
                   model_tx: OptimizerSpec,
                   quant_tx: Optional[OptimizerSpec] = None,
                   oscillation: Optional[OscillationConfig] = None) -> QATState:
    """The train state of a calibrated ``model``: its learned ranges made
    parameters, the two optimizers (``quant_tx=None`` trains the ranges
    with a second instance of ``model_tx``), the oscillation tracker.  The
    model's ``weight_spec_fn`` (where it has one) resolves each layer's
    own weight grid for dampening and freezing."""
    for path, names in quant_trainable_mask(model, config).items():
        model.get_submodule(path).make_range_trainable(names)
    quant_tx = quant_tx if quant_tx is not None else model_tx
    params, quant = partition_quant(model)
    weight_spec = (model.weight_spec_fn() if hasattr(model, "weight_spec_fn")
                   else config.weight_quant)
    osc_state = (init_osc_state(model, weight_spec)
                 if oscillation is not None and oscillation.freeze else None)
    return QATState(model=model, model_tx=model_tx, quant_tx=quant_tx,
                    optimizer=model_tx.build(params),
                    quant_optimizer=quant_tx.build(quant) if quant else None,
                    oscillation=oscillation, weight_spec=weight_spec,
                    osc_state=osc_state)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.to(torch.float32), labels.to(torch.long))


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def set_rng_streams(model: nn.Module, step: int) -> None:
    """The step's generators: the quantizers' stochastic rounding and the
    model's dropout."""
    dev = _device(model)
    noise = torch.Generator(device=dev)
    noise.manual_seed(QUANT_NOISE_SEED * 2 ** 32 + step)
    set_quant_noise(model, noise)
    if hasattr(model, "dropout_generator"):
        drop = torch.Generator(device=dev)
        drop.manual_seed(DROPOUT_SEED * 2 ** 32 + step)
        model.dropout_generator = drop


def _step_optimizer(opt: torch.optim.Optimizer, tx: OptimizerSpec,
                    step: int) -> None:
    for group in opt.param_groups:
        group["lr"] = tx.lr_at(step)
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()


def make_train_step(state: QATState, *, mode: str = "learn",
                    loss_fn: Callable = cross_entropy, train_bn: bool = True):
    """``step(state, x, y) -> (state, metrics)``: one QAT step in place
    (see the module docstring for its order)."""
    if mode not in ("learn", "calibrate_train"):
        raise ValueError(f"mode must be 'learn' or 'calibrate_train', not {mode!r}")

    def step(state: QATState, x, y):
        mesh = state.mesh
        with collectives.reducing_over(mesh and mesh.data_group):
            return _step(state, x, y)

    def _step(state: QATState, x, y):
        model, osc, mesh = state.model, state.oscillation, state.mesh
        dev = _device(model)
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x).to(dev, torch.float32)
        y = torch.as_tensor(np.asarray(y) if not isinstance(y, torch.Tensor)
                            else y).to(dev, torch.long)
        set_rng_streams(model, state.step)
        freeze = osc is not None and osc.freeze and state.osc_state is not None
        # a tensor-parallel model's full weights and gradients inside,
        # each rank's slices after (parallel/api.shard_qat_state)
        with gather_weights(mesh, model):
            old_q = ({".".join(p): layer.weight_q.state()
                      for p, layer in quantized_layers(model)} if freeze else None)
            if freeze:      # calibrate_train updates the state in the forward
                old_q = {k: {n: v.clone() for n, v in s.items()}
                         for k, s in old_q.items()}
            damp = None
            if osc is not None and osc.dampen:
                lam = _anneal(osc.dampen_weight, osc.dampen_weight_final,
                              state.step, osc.total_steps, osc.dampen_anneal_start)
                damp = lam.to(dev) * dampening_loss(model, state.weight_spec)
            logits = model(x, mode=mode, train_bn=train_bn)
            loss = loss_fn(logits, y)
            if damp is not None:
                loss = loss + damp
            for opt in (state.optimizer, state.quant_optimizer):
                if opt is not None:
                    opt.zero_grad(set_to_none=True)
            loss.backward()
            collectives.average_gradients(
                p for opt in (state.optimizer, state.quant_optimizer)
                if opt is not None for group in opt.param_groups
                for p in group["params"])
        _step_optimizer(state.optimizer, state.model_tx, state.step)
        loss_acc = torch.stack([loss.detach(),
                                (logits.argmax(-1) == y).float().mean()])
        if collectives.active():
            loss_acc = collectives.all_sum(loss_acc) / collectives.size()
        metrics = {"loss": float(loss_acc[0]), "accuracy": float(loss_acc[1])}
        if freeze:
            with gather_weights(mesh, model):
                metrics.update(apply_freezing(model, state.osc_state,
                                              state.weight_spec, state.step,
                                              osc, old_q))
        if mode == "learn" and state.quant_optimizer is not None:
            _step_optimizer(state.quant_optimizer, state.quant_tx, state.step)
        state.step += 1
        return state, metrics

    return step


def train_epoch(state: QATState, batches: Iterable, *, mode: str = "learn",
                train_bn: bool = True, step_fn=None):
    """One pass over ``batches``: (state, mean metrics)."""
    step_fn = step_fn or make_train_step(state, mode=mode, train_bn=train_bn)
    totals, n = {}, 0
    for x, y in batches:
        state, m = step_fn(state, x, y)
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + v
        n += 1
    if n == 0:
        raise ValueError("no training batches")
    return state, {k: v / n for k, v in totals.items()}


# ---- BN re-estimation ------------------------------------------------------------

@torch.no_grad()
def reestimate_bn_stats(model: nn.Module, batches: Iterable, *,
                        num_batches: int = 50, quant_w: bool = True,
                        quant_a: bool = True) -> nn.Module:
    """Replace every BN's running mean and (unbiased) variance by the mean
    over at most ``num_batches`` batches of each batch's statistics, from
    fixed-mode forwards with batch statistics (``train_bn``).  In place;
    returns the model."""
    bns = [m for m in model.modules()
           if isinstance(m, QuantizedLayerBase) and m.bn]
    momenta = [m.bn_momentum for m in bns]
    dev = _device(model)
    totals, n = None, 0
    try:
        for m in bns:
            m.bn_momentum = 1.0     # the running stats become the batch's
        for i, batch in enumerate(batches):
            if i >= num_batches:
                break
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                                else x).to(dev, torch.float32)
            set_rng_streams(model, i)
            model(x, mode="fixed", quant_w=quant_w, quant_a=quant_a,
                  train_bn=True)
            stats = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
            totals = stats if totals is None else [
                (a + c, b + d) for (a, b), (c, d) in zip(totals, stats)]
            n += 1
    finally:
        for m, mom in zip(bns, momenta):
            m.bn_momentum = mom
    if n == 0:
        raise ValueError("no batches for BN re-estimation")
    for m, (mean, var) in zip(bns, totals):
        m.running_mean.copy_(mean / n)
        m.running_var.copy_(var / n)
    return model

"""Checkpoint and resume of a calibrated model or a QAT state.

Mirrors ``fp8_quantization_tpu/utils/checkpoint.py`` (``save_checkpoint``,
``latest_step``, ``restore_checkpoint``) with its semantics: one
``step_<N>`` directory per save, only the newest ``keep`` kept, the newest
step restored unless one is named, ``FileNotFoundError`` when there is
none.  The format is the port's own, not orbax: ``step_<N>/state.pt``,
written by ``torch.save`` and read with ``torch.load(weights_only=True)``,
holding

* for an ``nn.Module``: its ``state_dict`` (weights, BN statistics, every
  quantizer's and estimator's state);
* for a ``QATState`` (training/qat.py): the model's ``state_dict``, both
  optimizers' ``state_dict``s, ``step`` and ``osc_state``.  The optimizer
  specs (learning rates and schedules) and the oscillation config are
  code, as JAX's optax transforms are: they come with the target.

Restore works in place, into a target of the same structure, as JAX
restores into ``target``'s tree, and returns it: a model built as the
saved one was, or the ``QATState`` that ``init_qat_state`` builds for it
(whose learned ranges are parameters).  Loading goes through
``load_state_dict``, so each quantizer records its cast format again
(nn/quantizers.py) and each layer's operand cache sees new weights
(nn/layers.py ``_operand``).

What is saved is the calibrated state before the bake, as JAX saves its
calibrated variables before it bakes (cli/image_net.py:288-291): a baked
or prepared model holds buffers that a fresh model does not (``w_factor``,
``w_int8``, the prepare pass's ``qprep``, ``kprep`` and ``prep_*``), or,
on 'parity', weights already quantized, so ``save_checkpoint`` refuses it.
A restored model goes through the bake, the prepare pass and the kernel
gate again, as a freshly calibrated one does.

Under torch.distributed (parallel/) rank 0 alone writes, the other ranks
wait at a barrier until the file is there, and every rank restores.  A
tensor-parallel model or QAT state (``parallel/api.shard_variables``,
``shard_qat_state``) is saved whole, as orbax saves JAX's global arrays:
every rank of a model group takes part in the all-gather of the sharded
tensors, and of the optimizers' moments of the sharded parameters (along
the same axis; scalars such as Adam's ``step`` are whole already), so the
file has the format and keys of an unsharded save.  A restore loads the
whole file in every rank and keeps each rank's slice, which is the state
``shard_qat_state`` would have built from the whole one; so one process
restores what tensor-parallel ranks saved, and the other way round.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch
from torch import nn

from fp8_quantization_tpu_torch.parallel import multihost
from fp8_quantization_tpu_torch.parallel.api import (
    full_optimizer_state_dicts, gather_weights, local_state_dict,
    slice_optimizer_state)

STATE_FILE = "state.pt"


def _steps(ckpt_dir: str) -> list:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and d.split("_")[1].isdigit())


def _model(target: Any) -> nn.Module:
    return target if isinstance(target, nn.Module) else target.model


def _state(target: Any) -> dict:
    """What a checkpoint of ``target`` holds."""
    from fp8_quantization_tpu_torch.nn.bake import is_baked, is_prepared

    model = _model(target)
    if is_baked(model) or is_prepared(model):
        raise ValueError(
            "save_checkpoint: the model is baked or prepared; save the "
            "calibrated model before nn/bake.bake_weights / "
            "bake_int8_weights and the prepare pass (their buffers do not "
            "load into a fresh model), as the JAX package saves its "
            "calibrated variables before it bakes")
    with gather_weights(None, model):
        state = {"model": model.state_dict()}
    if not isinstance(target, nn.Module):
        qopt = target.quant_optimizer
        opt, *qopt_state = full_optimizer_state_dicts(
            model, [target.optimizer] + ([qopt] if qopt is not None else []))
        state.update(
            optimizer=opt, quant_optimizer=qopt_state[0] if qopt_state else None,
            step=int(target.step), osc_state=target.osc_state)
    return state


def save_checkpoint(ckpt_dir: str, target: Any, step: int = 0,
                    keep: int = 1) -> str:
    """Save an ``nn.Module`` or a ``QATState`` to ``ckpt_dir/step_<N>``,
    keeping the newest ``keep`` steps; returns the step's directory."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step}")
    state = _state(target)
    if multihost.process_index() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        for s in _steps(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                          ignore_errors=True)
    multihost.barrier()
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step under ``ckpt_dir``, None when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, target: Any,
                       step: Optional[int] = None) -> Any:
    """Restore step ``step`` (the newest by default) into ``target`` in
    place and return it."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}", STATE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint {path}")
    state = torch.load(path, map_location="cpu", weights_only=True)
    model = _model(target)
    model.load_state_dict(local_state_dict(model, state["model"]))
    if isinstance(target, nn.Module):
        return target
    if "optimizer" not in state:
        raise ValueError(f"{path} holds a model, not a QAT state")
    target.optimizer.load_state_dict(state["optimizer"])
    if (state["quant_optimizer"] is None) != (target.quant_optimizer is None):
        raise ValueError("the checkpoint's quant optimizer does not match "
                         "the target's")
    if target.quant_optimizer is not None:
        target.quant_optimizer.load_state_dict(state["quant_optimizer"])
    slice_optimizer_state(model, [o for o in (target.optimizer,
                                              target.quant_optimizer)
                                  if o is not None])
    target.step = state["step"]
    device = next(model.parameters()).device
    target.osc_state = (None if state["osc_state"] is None else {
        layer: {k: v.to(device) for k, v in s.items()}
        for layer, s in state["osc_state"].items()})
    return target

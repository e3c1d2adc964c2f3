"""Multi-rank parallelism: the mesh, sharding rules, distributed
calibration, evaluation and QAT.

Mirrors ``fp8_quantization_tpu/parallel/api.py``, with one process per
rank (parallel/multihost.py) where JAX runs one program over a device
mesh.  The axes are JAX's:

* ``data``: the batch.  A rank keeps the rows of its data index
  (``batch_sharding``), and every reduction over the batch, which XLA
  inserts for a sharded array, is a collective over the data group
  (parallel/collectives.py): the range estimators' min / max / sums, BN's
  batch statistics in QAT, the evaluation's sums and the QAT gradients.
* ``model``: tensor parallelism by JAX's weight-gather strategy
  (``gather_weights``).  A tensor whose output-channel axis the model size
  divides, and is not 1, is sharded along it at rest; the others are
  replicated (JAX ``_tp_spec``).  At the forward's entry the slices are
  gathered over the model group, so the forward runs on the same full
  tensors as one process, with its numerics; after it, what the forward
  changed (calibration's ranges) is sliced back into each rank's shard,
  exactly, since every rank of a model group sees the same rows.  The
  kernels' output channels are never split across ranks (GSPMD's
  activation strategy): their tiles were chosen for the full widths.

Rank ``r`` of a ``data x model`` mesh sits at ``(r // model, r % model)``,
JAX's device order.  The functions take the port's ``nn.Module`` where
JAX takes a variables dict, and work on it in place.

The output channel is axis 0 of a layer's own tensors (weights in the
torch layouts, BN parameters and statistics, biases, the bake's
per-channel factor) and the last axis of a per-channel quantizer's state
(``maxval``, its ``qprep``, the MSE search's ``(n, C)`` / ``(M, n, C)``
and the line search's ``(n, C)`` carries), as in JAX's channels-last
layouts.  The prepare pass's kernel operands keep a full-width copy in
each layer's operand cache (nn/layers.py ``_operand``), whatever the
rule does to their buffers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from fp8_quantization_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data x model`` layout of the ranks, with this rank's groups
    (None where the axis has one rank)."""

    data: int
    model: int
    rank: int
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def __deepcopy__(self, memo):
        # the process groups belong to the process: a copied model (the
        # CLI's deployed copy) shares them
        return self


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over the ranks; ``data=-1`` takes every
    rank the model axis leaves.  Raises ``ValueError`` when ``data x
    model`` exceeds the world, as JAX does, and also when it falls short
    of it: a rank outside the mesh would have no work.  Every rank must
    call it (it makes the groups with ``torch.distributed.new_group``)."""
    world, rank = _world()
    if data == -1:
        data = world // model
    if data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model}: both axes need a rank")
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} > {world} ranks")
    if data * model < world:
        raise ValueError(f"mesh {data}x{model} < {world} ranks: every rank "
                         "must have a place")
    data_group = model_group = None
    if data > 1:
        for m in range(model):
            group = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = group
    if model > 1:
        for d in range(data):
            group = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = group
    return Mesh(data, model, rank, data_group, model_group)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The rows of a global batch that one data index keeps."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.count} data ranks")
        k = n // self.count
        return slice(self.index * k, (self.index + 1) * k)

    def __call__(self, x):
        return x[self.rows(len(x))]


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Shard the leading (batch) axis over 'data'."""
    return BatchSharding(mesh.data_index, mesh.data)


def shard_batch(mesh: Mesh, x):
    """This rank's rows of the global batch ``x``."""
    return batch_sharding(mesh)(x)


def _flat_broadcast(tensors: List[torch.Tensor]) -> None:
    """Broadcast ``tensors`` from rank 0 to every rank in place, one
    collective per device and dtype (bool travels as uint8).  Under NCCL a
    host tensor (Adam's step count) travels through the rank's card."""
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.device, t.dtype), []).append(t)
    nccl = dist.get_backend() == "nccl"
    for (device, dtype), ts in by_kind.items():
        wire = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([t.detach().reshape(-1).to(wire) for t in ts])
        if nccl and device.type == "cpu":
            flat = flat.cuda()
        dist.broadcast(flat, 0)
        offset = 0
        with torch.no_grad():
            for t in ts:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view(t.shape).to(dtype))
                offset += n


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every rank holds rank 0's values: calling it broadcasts tensors
    from rank 0 in place."""

    mesh: Mesh

    def __call__(self, tensors: Iterable[torch.Tensor]) -> None:
        tensors = [t for t in tensors if t is not None]
        if dist.is_initialized() and dist.get_world_size() > 1 and tensors:
            _flat_broadcast(tensors)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def _module_tensors(model: nn.Module) -> List[torch.Tensor]:
    return [t for t in itertools.chain(model.parameters(), model.buffers())
            if t is not None]


def replicate_variables(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Every parameter and buffer of ``model`` set to rank 0's values (in
    place; an unsharded model)."""
    _unshard(model)
    replicated(mesh)(_module_tensors(model))
    return model


# ---- tensor parallelism: JAX's weight-gather strategy ------------------------

def tp_axis(module: nn.Module, tensor: Optional[torch.Tensor],
            tp_size: int) -> Optional[int]:
    """The axis of ``tensor`` (a direct parameter or buffer of ``module``)
    sharded over 'model', or None to replicate it: the output-channel axis
    (axis 0 of a layer's tensors, the last axis of a per-channel
    quantizer's) where ``tp_size`` divides it and it is not 1."""
    if tensor is None or tensor.ndim == 0:
        return None
    channels = getattr(module, "num_channels", None)     # a quantizer
    axis = tensor.ndim - 1
    if channels is None:
        channels = getattr(module, "features", None)      # a layer
        axis = 0
    if (not isinstance(channels, int) or channels == 1 or channels % tp_size
            or tensor.shape[axis] != channels):
        return None
    return axis


def _gather_along(mesh: Mesh, slices) -> List[torch.Tensor]:
    """The full tensors of ``slices`` ((this rank's slice, axis) pairs):
    every rank's slices concatenated along their axes in model-index
    order, one all-gather per dtype over the model group (bool travels as
    uint8)."""
    by_dtype = {}
    for i, (t, _) in enumerate(slices):
        by_dtype.setdefault(t.dtype, []).append(i)
    fulls = [None] * len(slices)
    for dtype, idx in by_dtype.items():
        wire = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([slices[i][0].reshape(-1).to(wire) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(mesh.model)]
        dist.all_gather(parts, flat, group=mesh.model_group)
        offset = 0
        for i in idx:
            t, axis = slices[i]
            n = t.numel()
            fulls[i] = torch.cat([p[offset:offset + n].view(t.shape)
                                  for p in parts], dim=axis).to(dtype)
            offset += n
    return fulls


@dataclasses.dataclass
class _Shards:
    """A sharded model's record: (module, name, axis) of each sharded
    tensor and how deep the gathers nest.  Its ``enter`` and ``exit`` are
    the model's forward hooks (bound methods, so a deep copy of the model
    carries a record of its own); with no entries they do nothing."""

    mesh: Mesh
    entries: list
    depth: int = 0

    def _tensors(self):
        """(module, name, axis, kind, tensor): every sharded parameter's
        or buffer's data, then a parameter's gradient where it has one."""
        for mod, name, axis in self.entries:
            t = getattr(mod, name)
            yield mod, name, axis, "data", t.detach()
            if name in mod._parameters and t.grad is not None:
                yield mod, name, axis, "grad", t.grad

    @staticmethod
    def _set(mod, name, kind, value) -> None:
        if kind == "grad":
            mod._parameters[name].grad = value
        elif name in mod._parameters:
            mod._parameters[name].data = value
        else:
            mod._buffers[name] = value

    def gather(self) -> None:
        """Replace every slice by the full tensor (``_gather_along``)."""
        entries = list(self._tensors())
        fulls = _gather_along(self.mesh, [(t, axis) for _, _, axis, _, t in entries])
        for (mod, name, _, kind, _), full in zip(entries, fulls):
            self._set(mod, name, kind, full)

    def slice(self) -> None:
        """Keep this rank's slice of every recorded tensor."""
        i, size = self.mesh.model_index, self.mesh.model
        for mod, name, axis, kind, t in list(self._tensors()):
            k = t.shape[axis] // size
            self._set(mod, name, kind, t.narrow(axis, i * k, k).clone(
                memory_format=torch.contiguous_format))

    def enter(self, *_args) -> None:
        if self.entries and self.depth == 0:
            self.gather()
        self.depth += 1

    def exit(self, *_args) -> None:
        self.depth -= 1
        if self.entries and self.depth == 0:
            self.slice()


def _unshard(model: nn.Module) -> None:
    """Gather a sharded model for good (its hooks then do nothing)."""
    shards = getattr(model, "_fp8tpu_shards", None)
    if shards is None or not shards.entries:
        return
    if shards.depth == 0:
        shards.gather()
    shards.entries, shards.depth = [], 0


def shard_variables(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Shard ``model`` over 'model' by the rule of ``tp_axis`` (in place).

    Every rank first takes rank 0's values; then each keeps its slice of
    the sharded tensors (and of a parameter's gradient), and the model
    gathers them at every forward's entry and slices them back after it
    (``gather_weights``).  A sharded model is sharded again from its full
    state, so that buffers added since (the bake's, the prepare pass's)
    are covered.  With ``model=1`` this is plain replication."""
    replicate_variables(mesh, model)
    if mesh.model == 1:
        return model
    entries = []
    for mod in model.modules():
        for name, t in itertools.chain(mod._parameters.items(),
                                       mod._buffers.items()):
            axis = tp_axis(mod, t, mesh.model)
            if axis is not None:
                entries.append((mod, name, axis))
    shards = getattr(model, "_fp8tpu_shards", None)
    if shards is None:
        shards = model._fp8tpu_shards = _Shards(mesh, [])
        model.register_forward_pre_hook(shards.enter)
        model.register_forward_hook(shards.exit, always_call=True)
    shards.mesh, shards.entries = mesh, entries
    shards.slice()
    return model


@contextlib.contextmanager
def gather_weights(mesh: Mesh, model: nn.Module):
    """Inside the block ``model`` holds its full tensors (gathered over
    the model group); after it, each rank its slice of them again, with
    what the block changed.  A model that is not sharded is left as it
    is.

    JAX gathers inside its jitted step, where XLA's scheduler overlaps
    the weight gathers with compute; here they run at the block's entry,
    one collective per dtype."""
    shards = getattr(model, "_fp8tpu_shards", None)
    if shards is None or not shards.entries:
        yield model
        return
    shards.enter()
    try:
        yield model
    finally:
        shards.exit()


def state_bytes(model: nn.Module) -> int:
    """Bytes of ``model``'s parameters and buffers as it holds them."""
    return sum(t.numel() * t.element_size() for t in _module_tensors(model))


def operand_cache_bytes(model: nn.Module) -> int:
    """Bytes of the layers' kernel-operand caches (nn/layers.py
    ``_operand``) that no buffer of the model shares."""
    held = {t.data_ptr() for t in _module_tensors(model)}
    total = 0
    for mod in model.modules():
        for _key, t in getattr(mod, "_operand_cache", {}).values():
            if t.data_ptr() not in held:
                total += t.numel() * t.element_size()
    return total


# ---- distributed drivers: calibration/calibrate.py with the batch sharded ----

def calibrate_sharded(model: nn.Module, batches: Iterable, mesh: Mesh, *,
                      device, num_batches: Optional[int] = None,
                      tensor_parallel: bool = False, quant_w: bool = True,
                      quant_a: bool = True,
                      stats: Optional[collectives.CollectiveStats] = None
                      ) -> nn.Module:
    """Data-parallel (optionally tensor-parallel) calibration of global
    batches: each rank calibrates on its rows, every estimator reducing
    over the data group inside the forward, before it sets its range, so
    that deeper layers calibrate on the global ranges of the shallower
    ones, as JAX's sharded calibration does.  Equal to one process for
    the min/max estimators (order-free), within float32 summation order
    for the MSE and line searches.  ``stats`` counts the collectives."""
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.parallel.multihost import local_batches

    (shard_variables if tensor_parallel else replicate_variables)(mesh, model)
    with collectives.reducing_over(mesh.data_group, stats):
        return calibrate(model, local_batches(batches, mesh, num_batches),
                         device=device, num_batches=num_batches,
                         quant_w=quant_w, quant_a=quant_a)


def evaluate_sharded(model: nn.Module, batches: Iterable, mesh: Mesh, *,
                     device, tensor_parallel: bool = False,
                     max_batches: Optional[int] = None, **kw) -> dict:
    """Data-parallel evaluation of global ``(x, y)`` batches: each rank
    evaluates its rows and the sums are reduced over the data group, so
    every rank returns the global metrics."""
    from fp8_quantization_tpu_torch.calibration.calibrate import evaluate
    from fp8_quantization_tpu_torch.parallel.multihost import local_batches

    (shard_variables if tensor_parallel else replicate_variables)(mesh, model)
    with collectives.reducing_over(mesh.data_group):
        return evaluate(model, local_batches(batches, mesh, max_batches),
                        device=device, max_batches=max_batches, **kw)


def shard_qat_state(mesh: Mesh, state, tensor_parallel: bool = False):
    """A QAT state (training/qat.py) placed for mesh execution: the model,
    both optimizers' state and the oscillation state set to rank 0's, and
    the state's ``mesh`` set, so that the step averages the gradients, and
    takes BN's batch statistics and the metrics, over the data group.

    With ``tensor_parallel`` the model is sharded by ``shard_variables``
    and the optimizers' state with it: the step runs the forward and the
    backward on the gathered weights (every rank of a model group computes
    the same full gradients, on the same rows), keeps each rank's slice of
    the gradients, and the optimizers step on the slices, so each rank
    holds the moments of its slice alone.  The oscillation state stays
    whole in every rank (freezing runs on the gathered weights)."""
    replicate_variables(mesh, state.model)
    optimizers = [o for o in (state.optimizer, state.quant_optimizer)
                  if o is not None]
    tensors = []
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                tensors += [v for v in opt.state.get(p, {}).values()
                            if isinstance(v, torch.Tensor)]
    for layer in sorted(state.osc_state or {}):
        tensors += list(state.osc_state[layer].values())
    replicated(mesh)(tensors)
    if tensor_parallel:
        shard_variables(mesh, state.model)
        slice_optimizer_state(state.model, optimizers)
    state.mesh = mesh
    return state


def _sharded(model: nn.Module) -> Optional[_Shards]:
    shards = getattr(model, "_fp8tpu_shards", None)
    return shards if shards is not None and shards.entries else None


def _moments(shards: _Shards, optimizers, full: bool):
    """(optimizer state dict of a parameter, key, axis) of every moment of
    a sharded parameter that is whole (``full``) or this rank's slice: the
    tensors of the parameter's shape, whole or sliced along its axis.
    Scalars (Adam's ``step``) are neither."""
    for mod, name, axis in shards.entries:
        p = mod._parameters.get(name)
        if p is None:
            continue
        shape = list(p.shape)
        if shards.depth and not full:       # the model holds its full tensors
            shape[axis] //= shards.mesh.model
        elif not shards.depth and full:
            shape[axis] *= shards.mesh.model
        for opt in optimizers:
            st = opt.state.get(p, {})
            for k, v in st.items():
                if isinstance(v, torch.Tensor) and list(v.shape) == shape:
                    yield st, k, axis


def slice_optimizer_state(model: nn.Module, optimizers) -> None:
    """Keep this rank's slice of each whole moment of a sharded parameter
    (in place; what ``shard_qat_state`` does, and a restore of a whole
    state after it)."""
    shards = _sharded(model)
    if shards is None:
        return
    i, size = shards.mesh.model_index, shards.mesh.model
    for st, k, axis in list(_moments(shards, optimizers, full=True)):
        n = st[k].shape[axis] // size
        st[k] = st[k].narrow(axis, i * n, n).clone()


def full_optimizer_state_dicts(model: nn.Module, optimizers) -> list:
    """Each optimizer's ``state_dict`` with the moments of every sharded
    parameter gathered over the model group, as one process holds them
    (every rank of the group must call it); the optimizers keep their
    slices."""
    shards = _sharded(model)
    if shards is None:
        return [opt.state_dict() for opt in optimizers]
    moments = list(_moments(shards, optimizers, full=False))
    fulls = _gather_along(shards.mesh, [(st[k], axis) for st, k, axis in moments])
    kept = [st[k] for st, k, _ in moments]
    for (st, k, _), full in zip(moments, fulls):
        st[k] = full
    try:
        dicts = [opt.state_dict() for opt in optimizers]
        # state_dict() shares each parameter's state dict with the optimizer
        for d in dicts:
            d["state"] = {i: dict(s) for i, s in d["state"].items()}
    finally:
        for (st, k, _), t in zip(moments, kept):
            st[k] = t
    return dicts


def local_state_dict(model: nn.Module, state: dict) -> dict:
    """``state`` (a whole model's ``state_dict``) as ``model`` holds it:
    this rank's slice of each sharded tensor where the model holds its
    slices, the whole state where it is not sharded or holds its full
    tensors."""
    shards = _sharded(model)
    if shards is None or shards.depth:
        return state
    names = {id(m): n for n, m in model.named_modules()}
    i, size = shards.mesh.model_index, shards.mesh.model
    local = dict(state)
    for mod, name, axis in shards.entries:
        key = f"{names[id(mod)]}.{name}" if names[id(mod)] else name
        n = local[key].shape[axis] // size
        local[key] = local[key].narrow(axis, i * n, n).clone()
    return local

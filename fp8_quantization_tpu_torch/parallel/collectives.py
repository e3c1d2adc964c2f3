"""The reductions over the batch that XLA inserts for a sharded batch.

No JAX counterpart: under GSPMD the whole batch is one array sharded over
the mesh's ``data`` axis, so every ``jnp.min`` / ``max`` / ``sum`` /
``mean`` that a range estimator, a BN layer or the evaluation takes over
it is already global (JAX ``parallel/api.py``, module docstring).  With
one process per rank the port writes those reductions by hand, and this
module holds them.

``reducing_over(group)`` opens a scope in which ``all_minmax``,
``all_sum``, ``all_sum_grad`` and ``all_gather`` reduce over ``group`` (a
``torch.distributed`` group of the ranks that hold one global batch
between them, in the order of their rows), and ``rand_rows`` draws a
rank's rows of noise drawn at the global batch.  Outside a scope, or over
a group of one rank, each returns what one process computes, so that
every single-process path stays bit for bit as it was.  ``local()`` suspends
the scope: a weight quantizer observes a tensor that every rank holds
whole, and reduces it locally without a collective.

Each collective runs on the tensor's own device.  Gloo takes CUDA tensors
for every collective used here (``all_reduce`` with SUM and MAX,
``broadcast``, ``all_gather``; checked on an H100 with two ranks on one
card), so nothing is staged through host memory.  Gloo returns the same
reduced bytes to every rank, as NCCL does, so the ranks' states stay
bit-equal.

A scope may carry a ``CollectiveStats``, which counts the collectives,
their elements and their host seconds (each call waits for its result:
gloo's calls are synchronous; the NCCL path synchronises the device).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class CollectiveStats:
    """Collectives issued inside a scope: their number, the elements they
    carried and the host seconds they took."""

    count: int = 0
    elements: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.count, self.elements, self.seconds = 0, 0, 0.0


@dataclasses.dataclass(frozen=True)
class _Scope:
    group: object
    size: int
    index: int      # this rank's place in the group: its rows of the batch
    stats: Optional[CollectiveStats]


_SCOPE: contextvars.ContextVar[Optional[_Scope]] = contextvars.ContextVar(
    "fp8tpu_reducing_over", default=None)


def group_size(group) -> int:
    """Ranks in ``group`` (None: one rank, no group)."""
    return 1 if group is None else dist.get_world_size(group)


@contextlib.contextmanager
def reducing_over(group, stats: Optional[CollectiveStats] = None):
    """Reduce over the ranks of ``group`` inside the ``with`` block (a
    group of one rank, or None, reduces nothing)."""
    size = group_size(group)
    token = _SCOPE.set(_Scope(group, size, dist.get_rank(group), stats)
                       if size > 1 else None)
    try:
        yield
    finally:
        _SCOPE.reset(token)


@contextlib.contextmanager
def local():
    """Reduce nothing inside the ``with`` block."""
    token = _SCOPE.set(None)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def active() -> bool:
    """Whether a scope over more than one rank is open."""
    return _SCOPE.get() is not None


def size() -> int:
    """Ranks of the open scope (1 outside one)."""
    scope = _SCOPE.get()
    return 1 if scope is None else scope.size


def _timed(scope: _Scope, t: torch.Tensor, run) -> None:
    t0 = time.perf_counter()
    run()
    if scope.stats is not None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        scope.stats.count += 1
        scope.stats.elements += t.numel()
        scope.stats.seconds += time.perf_counter() - t0


def _all_reduce(t: torch.Tensor, op, scope: _Scope) -> torch.Tensor:
    out = t.detach().clone()
    _timed(scope, out, lambda: dist.all_reduce(out, op=op, group=scope.group))
    return out


def all_minmax(lo: torch.Tensor, hi: torch.Tensor):
    """The elementwise minimum of ``lo`` and maximum of ``hi`` over the
    scope's ranks, in one collective: the maximum of ``-lo`` and ``hi``
    side by side (negation is exact)."""
    scope = _SCOPE.get()
    if scope is None:
        return lo, hi
    both = _all_reduce(torch.stack([-lo, hi.to(lo.dtype)]), dist.ReduceOp.MAX,
                       scope)
    return -both[0], both[1].to(hi.dtype)


def rand_rows(shape, generator: torch.Generator, dtype=None,
              device=None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``, where axis 0 is this
    rank's share of the batch: inside a scope the draw is made at the
    global batch's shape and this rank keeps its rows, so that the ranks
    hold between them the noise one process draws for the whole batch (as
    JAX draws one mask over its sharded batch) and the generator moves on
    as far as it would there."""
    scope = _SCOPE.get()
    if scope is None:
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)
    n = shape[0]
    full = torch.rand((n * scope.size,) + tuple(shape[1:]), generator=generator,
                      dtype=dtype, device=device)
    return full[scope.index * n:(scope.index + 1) * n]


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum over the scope's ranks (no gradient)."""
    scope = _SCOPE.get()
    return t if scope is None else _all_reduce(t, dist.ReduceOp.SUM, scope)


class _AllSum(torch.autograd.Function):
    """The sum over the ranks, whose backward sums the ranks' gradients:
    each rank's input then receives the gradient of the ranks' summed
    losses, as one process's would at the global batch."""

    @staticmethod
    def forward(ctx, t, scope):
        ctx.scope = scope
        return _all_reduce(t, dist.ReduceOp.SUM, scope)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, dist.ReduceOp.SUM, ctx.scope), None


def all_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """``all_sum`` through which a gradient flows (BN's batch statistics
    in QAT)."""
    scope = _SCOPE.get()
    return t if scope is None else _AllSum.apply(t, scope)


def all_gather(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim``, in rank order (no
    gradient)."""
    scope = _SCOPE.get()
    if scope is None:
        return t
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(scope.size)]
    _timed(scope, src, lambda: dist.all_gather(parts, src, group=scope.group))
    return torch.cat(parts, dim=dim)


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Replace each gradient by its mean over the scope's ranks, in one
    collective over a flat buffer (a missing gradient counts as zero, as
    the QAT step then gives it)."""
    scope = _SCOPE.get()
    if scope is None:
        return
    params = list(params)
    grads: List[torch.Tensor] = [
        torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    if not grads:
        return
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                       dist.ReduceOp.SUM, scope) / scope.size
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g).clone()
        offset += n

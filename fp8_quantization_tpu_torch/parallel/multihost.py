"""Multi-process execution glue.

Mirrors ``fp8_quantization_tpu/parallel/multihost.py``.  JAX runs one
process per host over all of that host's devices; the port runs one
process per rank, each on one device, as ``torchrun`` launches them:

    torchrun --nproc-per-node 2 -m fp8_quantization_tpu_torch.cli.image_net \\
        validate-quantized --data-parallel 2 ...

``initialize`` joins the ranks into one ``torch.distributed`` group, from
its arguments or from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``).  With one process and
no arguments it does nothing, as JAX's does.  The backend is NCCL where
every rank has a card of its own, gloo where ranks share a card (NCCL
refuses two ranks on one device) or run on the CPU; compute stays on the
card either way.

JAX's ``host_local_batch_to_global`` assembles one global array from the
hosts' local batches.  PyTorch has no global array: its counterpart is
``local_rows``, a rank's rows of a global batch.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from fp8_quantization_tpu_torch.device import resolve_device
from fp8_quantization_tpu_torch.parallel.api import batch_sharding

log = logging.getLogger(__name__)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def rank_device(device: str = "cuda") -> torch.device:
    """The device of this rank: ``cuda:{LOCAL_RANK % cards}`` on the card
    (raises where there is none, through ``resolve_device``), else the
    CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    index = (_env_int("LOCAL_RANK") or 0) % torch.cuda.device_count()
    return torch.device("cuda", index)


def choose_backend(world_size: int, device: torch.device) -> str:
    """NCCL where each rank of this host (``LOCAL_WORLD_SIZE``, else the
    world) has a card of its own, else gloo."""
    local = _env_int("LOCAL_WORLD_SIZE") or world_size
    if device.type == "cuda" and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None, device: str = "cuda") -> dict:
    """Join this process to the ranks' group (no-op for one process and no
    arguments).

    With no arguments, torchrun's environment; for a manual launch pass
    them: ``initialize("tcp://localhost:29500", world_size=2, rank=<0|1>)``.
    ``device`` is where this rank computes ("cuda" or "cpu").  Returns
    JAX's dict of the topology: ``process_index``, ``process_count``,
    ``local_devices``, ``global_devices``, ``shard_id``, ``num_shards``.
    """
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if not dist.is_initialized() and (init_method or (world_size or 1) > 1):
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = backend or choose_backend(world_size or 1, dev)
        log.info("torch.distributed: backend %s for %s ranks on %s", backend,
                 world_size, dev)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    index = dist.get_rank() if dist.is_initialized() else 0
    count = dist.get_world_size() if dist.is_initialized() else 1
    info = {"process_index": index, "process_count": count,
            "local_devices": 1, "global_devices": count,
            # feed these to make_dataloaders so ranks read disjoint shards
            "shard_id": index, "num_shards": count}
    log.info("distributed topology: %s", info)
    return info


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the ranks' group (nothing without one): a barrier, so that no
    rank leaves while another still talks to it, then
    ``destroy_process_group``.  A process that exits with its group alive
    can abort in the backend's teardown."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def local_rows(batch, mesh):
    """This rank's rows of a global batch (an array, or a tuple / list of
    arrays with one leading batch axis): the ``data`` index's equal share,
    in order; the whole batch without a mesh.  Raises ``ValueError`` when
    ``data`` does not divide the batch."""
    if mesh is None:
        return batch
    rows = batch_sharding(mesh)
    if isinstance(batch, (tuple, list)):
        return type(batch)(rows(b) for b in batch)
    return rows(batch)


def local_batches(batches, mesh, limit: Optional[int] = None):
    """``local_rows`` of each global batch, at most ``limit`` of them."""
    for i, b in enumerate(batches):
        if limit is not None and i >= limit:
            break
        yield local_rows(b, mesh)

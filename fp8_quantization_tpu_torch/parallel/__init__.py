"""Distribution over ``torch.distributed`` (JAX ``parallel/``): the mesh,
the sharding rules, data-parallel calibration, evaluation and QAT, and
weight-gather tensor parallelism."""

from fp8_quantization_tpu_torch.parallel.api import (  # noqa: F401
    Mesh, batch_sharding, calibrate_sharded, evaluate_sharded, gather_weights,
    make_mesh, replicate_variables, replicated, shard_batch, shard_qat_state,
    shard_variables)
from fp8_quantization_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize, local_rows)

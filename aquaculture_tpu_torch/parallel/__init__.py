"""Multi-process execution of the PyTorch port over torch.distributed.

Counterpart of aquaculture_tpu/parallel: a (data, model) layout of the
world's ranks with one process group per axis (mesh.py), the multi-host
serving runner with its corpus shards, chunk manifests and table gather
(pod.py), and the data- and model-parallel train step (sharded.py). Where
the JAX package leaves the collectives to GSPMD over one global program,
the port runs one process per GPU and calls them itself: NCCL for device
tensors on the card, gloo on the CPU and for host tables.
"""

from aquaculture_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_shardings,
    put_global,
    replicated,
    shard_batch,
    shard_local_batch,
)

"""Data and tensor parallelism over torch.distributed.

Port of ``kokoro_tpu/parallel/`` for the ``('data', 'model')`` mesh:
``mesh.py`` (process start-up, the mesh and its process groups, batch
placement) and ``tp.py`` (Megatron's column/row rules and the layout of the
parameters).  The semantics are the reference's single-device ones: global
batch = sum of the per-rank batches, identical loss masking, EMA, schedules
and counters advancing per optimizer step on global quantities.  The ``seq``
and ``stage`` axes (``pp.py``, ``pp_step.py``) are the next slice
(ROADMAP.md §1).
"""

from kokoro_tpu_torch.parallel.mesh import (
    Mesh, batch_axis_index, create_mesh, dp_size, init_distributed, mesh_size,
    process_local_rows, round_up_to_multiple, seq_size, shard_batch, tp_size,
)
from kokoro_tpu_torch.parallel.tp import (
    Layout, Split, gather_tree, param_split, shard_model, shard_tree,
)

__all__ = [
    "Layout", "Mesh", "Split", "batch_axis_index", "create_mesh", "dp_size",
    "gather_tree", "init_distributed", "mesh_size", "param_split", "process_local_rows",
    "round_up_to_multiple", "seq_size", "shard_batch", "shard_model", "shard_tree",
    "tp_size",
]

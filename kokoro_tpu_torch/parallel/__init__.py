"""Data, tensor, sequence and pipeline parallelism over torch.distributed.

Port of ``kokoro_tpu/parallel/``: ``mesh.py`` (process start-up, the mesh
and its process groups, batch placement, the ``seq`` axis's frame windows
and gathers), ``tp.py`` (Megatron's column/row rules and the layout of the
parameters over ``model``), ``pp.py`` (GPipe over ``stage``) and
``pp_step.py`` (the pipelined training step).  The semantics are the
reference's single-device ones: global batch = sum of the per-rank batches,
identical loss masking, EMA, schedules and counters advancing per optimizer
step on global quantities.  ``pp_step``'s names load on first use, since
that module imports the training step, which imports the model, which
imports this package.
"""

from kokoro_tpu_torch.parallel.mesh import (
    SEQ_AXIS, STAGE_AXIS, Mesh, batch_axis_index, batch_pspec, create_mesh, dp_size,
    frame_window, gather_frames, init_distributed, mesh_size, process_local_rows,
    round_up_to_multiple, seq_gather, seq_size, seq_window, shard_batch, tp_size,
)
from kokoro_tpu_torch.parallel.pp import (
    assert_grads_match, create_pp_mesh, pipeline_apply, sequential_apply, stack_layer_params,
    stage_layers, stage_size, unstack_layer_params,
)
from kokoro_tpu_torch.parallel.tp import (
    Layout, Split, gather_tree, param_split, shard_model, shard_tree,
)

_PP_STEP = ("make_pp_loss_fn", "make_pp_train_step", "pp_step_gradients")

__all__ = [
    "Layout", "Mesh", "SEQ_AXIS", "STAGE_AXIS", "Split", "assert_grads_match",
    "batch_axis_index", "batch_pspec", "create_mesh", "create_pp_mesh", "dp_size",
    "frame_window", "gather_frames", "gather_tree", "init_distributed", "mesh_size",
    "param_split", "pipeline_apply", "process_local_rows", "round_up_to_multiple",
    "seq_gather", "seq_size", "seq_window", "sequential_apply", "shard_batch", "shard_model",
    "shard_tree", "stack_layer_params", "stage_layers", "stage_size", "tp_size",
    "unstack_layer_params", *_PP_STEP,
]


def __getattr__(name):
    if name in _PP_STEP:
        from kokoro_tpu_torch.parallel import pp_step

        return getattr(pp_step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

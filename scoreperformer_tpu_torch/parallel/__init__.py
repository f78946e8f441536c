"""Training on several devices with torch.distributed: the counterpart of
scoreperformer_tpu/parallel (the process mesh, the collectives, the model
and expert splits, the pipeline, the launcher, the dry run). `shard`,
`pipeline`, `launch`, `workers` and `dryrun` import the models and are
imported by name."""
from .collectives import (
    all_gather,
    all_reduce,
    copy_to_group,
    data_share,
    data_total,
    gather_rows,
    partial_ratio,
    reduce_from_group,
)
from .mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    ProcessMesh,
    current,
    default_data_axis,
    make_pipeline_mesh,
    maybe_distributed_initialize,
    mesh_layout,
    pipeline_layout,
    rank_device,
    zero_split_dim,
)

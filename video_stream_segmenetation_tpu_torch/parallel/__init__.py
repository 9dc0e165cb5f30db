"""Mesh and sharding layer: stream-batch data parallelism over CUDA devices
(port of ``parallel/``)."""

from video_stream_segmenetation_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    data_parallel_forward,
    gather_rows,
    gather_stream_tree,
    installed_forward,
    make_mesh,
    reduce_sum,
    replicate_tree,
    replicated,
    resolve_device,
    shard_replicas,
    shard_stream_tree,
    sharded_step,
    stream_sharding,
)

from dh3d_tpu.parallel.mesh import (  # noqa: F401
    data_parallel_mesh,
    replicate_spec,
    shard_batch_spec,
)

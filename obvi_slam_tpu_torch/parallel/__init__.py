"""Multi-device global BA: meshes over ``torch.distributed`` ranks, the
factor-axis shards, the collectives (``comm``) and their audit."""

from obvi_slam_tpu_torch.parallel import audit, comm  # noqa: F401
from obvi_slam_tpu_torch.parallel.distributed import (  # noqa: F401
    global_mesh,
    initialize as initialize_distributed,
    shard_sessions,
)
from obvi_slam_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate,
    shard_plan,
    shard_problem,
    shard_tables,
    shard_weights,
    sharded_compute_step,
)

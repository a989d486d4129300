"""Multi-device bundle adjustment over torch.distributed.

Port of caliscope_tpu/parallel/: one process per device, each rank solving
its shard of the problem (the dense layout's points, or the sparse layout's
observation rows) with the camera parameters replicated, and every sum over
the sharded axis all-reduced (parallel/sharded.py).
"""

from caliscope_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    check_same_problem,
    make_obs_mesh,
    shard_dense_problem,
    shard_problem,
    sharded_lm_iteration,
)

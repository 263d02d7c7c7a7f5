"""Parallel/distributed layer: device meshes, sharded meta steps, fleets.

The reference has no parallelism of any kind (SURVEY.md section 2: single
global device, serial task loop, serial region loop). This package realizes
the workload's latent parallelism:

  * meta-batch data parallelism (`meta_dp.py`) — tasks sharded
    across a `jax.sharding.Mesh`, psum-reduced meta-gradients — optionally
    combined with node (spatial) model parallelism on a 2-D dp x sp mesh
    (`make_parallel_meta_step_2d`);
  * embarrassingly-parallel region-adaptation fleet (`fleet.py`) —
    independent per-region jobs partitioned across hosts/processes over DCN.
"""

from weatherforecast_stgcn_maml_tpu.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_mesh_2d,
    replicated,
    shard_task_batch_2d,
    task_batch_sharding,
)
from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import (  # noqa: F401
    make_parallel_meta_step,
    make_parallel_meta_step_2d,
)

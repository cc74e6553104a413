"""Multi-device batching: the env batch split over torch devices
(`mesh.make_env_mesh`, `mesh.shard_batch`) and the zero-communication
sharded engine (`sharded.ShardedEnvs`)."""

from metaworld_tpu_torch.parallel.mesh import make_env_mesh, shard_batch  # noqa: F401
from metaworld_tpu_torch.parallel.sharded import ShardedEnvs, shard_seed  # noqa: F401

from .mesh import make_mesh, shard_theta, sharded_solve  # noqa: F401
from .consensus import consensus_indices, consensus_solve  # noqa: F401

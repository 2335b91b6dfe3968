"""Process mesh, sharding rules and multi-process collectives (the data,
fsdp and tensor axes; pipe is ROADMAP.md queue A item 7b-ii)."""

from ultravox_torch.parallel.mesh import Mesh, MeshConfig, initialize_multihost, make_mesh  # noqa: F401
from ultravox_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    gather,
    gather_layer,
    gather_whole,
    param_pspecs,
    shard_params,
)

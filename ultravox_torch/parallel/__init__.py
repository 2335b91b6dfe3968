"""Process mesh, sharding rules, multi-process collectives and the GPipe
schedule (the data, fsdp, tensor and pipe axes)."""

from ultravox_torch.parallel.mesh import Mesh, MeshConfig, initialize_multihost, make_mesh  # noqa: F401
from ultravox_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    gather,
    gather_layer,
    gather_whole,
    param_pspecs,
    shard_params,
)
from ultravox_torch.parallel.pipeline import (  # noqa: F401
    pipeline_layers,
    pipelined_decoder_hidden,
)

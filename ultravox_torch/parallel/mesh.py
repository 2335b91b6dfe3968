"""The process mesh over the named axes ``("data", "fsdp", "tensor", "pipe")``.

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets
XLA insert every collective. Here each process drives one device (one
card, ``cuda:LOCAL_RANK``, or the CPU), and the mesh is the processes of
the default ``torch.distributed`` group laid out row-major over the four
axes, with a process group for each axis and one for the batch axes
``(data, fsdp)``:

- ``data``: pure data parallelism; gradients are summed over it;
- ``fsdp``: parameter sharding (ZeRO-3): each process holds a 1/fsdp slice
  of every leaf whose rule names ``fsdp`` and gathers it whole just before
  use (``sharding.py``); the batch is split over it too;
- ``tensor``: Megatron splits of the attention heads and the FFN inside
  both towers' layers (``sharding.py``); tensor peers hold the same rows
  of the batch;
- ``pipe``: GPipe stages over the decoder layer stack (``pipeline.py``):
  each stage holds L/pipe contiguous layers; pipe peers are adjacent ranks
  (the last axis) and hold the same rows of the batch.

A process is launched by ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or given the JAX config's
keys (``coordinator_address``, ``num_processes``, ``process_id``):
``initialize_multihost`` joins the group, NCCL on the card and gloo on the
CPU. A plain single process needs neither, and a mesh of one process has
no groups: every collective is skipped.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ultravox_torch.parallel.collectives import process_count, process_index

logger = logging.getLogger(__name__)

AXES = ("data", "fsdp", "tensor", "pipe")
BATCH_AXES = ("data", "fsdp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """-1 for one axis means "use all remaining devices"."""

    data: int = 1
    fsdp: int = -1
    tensor: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> tuple:
        dims = [self.data, self.fsdp, self.tensor, self.pipe]
        if dims.count(-1) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = math.prod(d for d in dims if d != -1)
        if -1 in dims:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {known}")
            dims[dims.index(-1)] = n_devices // known
        if math.prod(dims) > n_devices:
            raise ValueError(f"mesh {dims} needs more than the {n_devices} available devices")
        return tuple(dims)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's place on the mesh: each axis's size (``shape``, as
    ``jax.sharding.Mesh.shape`` reads), its coordinate on each axis, and
    the process group of each axis and of the batch axes. A group is None
    where nothing needs to travel: no process group at all, or an axis (or
    the batch axes) of size 1, a mesh of one process included."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any]  # axis name or "batch" -> process group or None

    @property
    def batch_group(self):
        return self.groups["batch"]

    @property
    def batch_shards(self) -> int:
        return self.shape["data"] * self.shape["fsdp"]

    @property
    def batch_index(self) -> int:
        """This process's shard of the batch: its (data, fsdp) coordinate,
        row-major; tensor and pipe peers share it and read the same rows."""
        return self.coords["data"] * self.shape["fsdp"] + self.coords["fsdp"]

    @property
    def rank(self) -> int:
        """This process's rank: its coordinates, row-major over AXES."""
        return int(np.ravel_multi_index([self.coords[a] for a in AXES],
                                        [self.shape[a] for a in AXES]))

    @property
    def stage(self) -> int:
        """This process's pipeline stage (its ``pipe`` coordinate)."""
        return self.coords["pipe"]

    @property
    def n_stages(self) -> int:
        return self.shape["pipe"]

    @property
    def prev_stage_rank(self) -> Optional[int]:
        """The rank of the stage before this one (pipe is the last axis,
        so it is the rank before), None on the first stage."""
        return self.rank - 1 if self.stage > 0 else None

    @property
    def next_stage_rank(self) -> Optional[int]:
        """The rank of the stage after this one, None on the last stage."""
        return self.rank + 1 if self.stage < self.n_stages - 1 else None

    @classmethod
    def local(cls, config: Optional[MeshConfig] = None, n_devices: int = 1) -> "Mesh":
        """The mesh's shape seen from rank 0 with no process group: what
        the sharding rules read (``param_pspecs``) without any collective."""
        shape = (config or MeshConfig()).resolve(n_devices)
        return cls(dict(zip(AXES, shape)), dict.fromkeys(AXES, 0),
                   dict.fromkeys(AXES + ("batch",)))


def _groups(shape: tuple, rank: int) -> Dict[str, Any]:
    """The group of each axis (and of the batch axes) that holds ``rank``.
    Every process calls ``new_group`` for every block, in one order."""
    world = math.prod(shape)
    ids = np.arange(world).reshape(shape)
    blocks = {a: np.moveaxis(ids, i, -1).reshape(-1, shape[i]) for i, a in enumerate(AXES)}
    blocks["batch"] = np.moveaxis(ids, (0, 1), (-2, -1)).reshape(-1, shape[0] * shape[1])
    out: Dict[str, Any] = {}
    for name, rows in blocks.items():
        out[name] = None
        for row in rows.tolist():
            if len(row) == 1:
                group = None
            elif len(row) == world:
                group = dist.group.WORLD
            else:
                group = dist.new_group(row)
            if rank in row:
                out[name] = group
    return out


def make_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh over every process of the default group (one device each);
    a plain single process gets a mesh of ones with no groups."""
    config = config or MeshConfig()
    world = process_count()
    shape = config.resolve(world)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(AXES, shape))} must cover all {world} processes "
                         "(one device a process)")
    rank = process_index()
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, shape))))
    groups = (_groups(shape, rank) if dist.is_available() and dist.is_initialized()
              else dict.fromkeys(AXES + ("batch",)))
    logger.info("mesh %s, process %d at %s", dict(zip(AXES, shape)), rank, coords)
    return Mesh(dict(zip(AXES, shape)), coords, groups)


def local_rank(rank: int = 0) -> int:
    """A process's card on its host: torchrun's ``LOCAL_RANK``, else its
    ``rank`` modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def rank_device(device: torch.device) -> torch.device:
    """``device`` made explicit: a card without an index is the one this
    process is bound to (``cuda:LOCAL_RANK`` after initialize_multihost)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Join the default process group (replaces dist.init_process_group,
    reference train.py:126-130). Call it before anything touches a device.

    The group is torchrun's (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT`` in the environment) or given by the JAX config's keys:
    ``coordinator_address`` "host:port" (or an init URL such as
    ``file:///shared/rendezvous``), ``num_processes`` and ``process_id``.
    The backend follows the ``device`` the run asked for: NCCL for a card
    (None means the card wherever CUDA is present), each process first
    bound to its card ``cuda:LOCAL_RANK`` (object collectives stage
    there), and gloo for the CPU. A plain single process (no torchrun
    environment, no argument, or ``num_processes`` <= 1) is left alone, as
    is a group that is already up."""
    if dist.is_initialized():
        return
    if num_processes is not None and num_processes <= 1:
        return
    env = os.environ
    torchrun = "RANK" in env and "WORLD_SIZE" in env
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    if not explicit and not torchrun:
        return
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 0))
    rank = process_id if process_id is not None else (
        int(env["RANK"]) if "RANK" in env else None)
    if not world or rank is None:
        raise ValueError(
            f"a multi-process run needs its world size and rank: num_processes {num_processes}, "
            f"process_id {process_id}, WORLD_SIZE {env.get('WORLD_SIZE')}, RANK {env.get('RANK')}")
    if coordinator_address:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    else:
        raise ValueError("a multi-process run needs coordinator_address or torchrun's "
                         "MASTER_ADDR and MASTER_PORT")
    card = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    if card:
        backend = "nccl"
        torch.cuda.set_device(local_rank(rank))
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    logger.info("process group: %s, process %d of %d", backend, rank, world)

"""Multi-process helpers (reference: training/ddp_utils.py), read from the
default ``torch.distributed`` process group.

Every helper degenerates to a no-op in a plain single process (no process
group, or a group of one), so the whole stack runs single-process, as the
JAX package's ``parallel/collectives.py`` does at ``process_count() == 1``.
"""

from __future__ import annotations

from typing import Any, Iterator, List

import torch.distributed as dist


def _group_live() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _group_live() else 0


def process_count() -> int:
    return dist.get_world_size() if _group_live() else 1


def is_global_master() -> bool:
    return process_index() == 0


def all_gather_list(items: List[Any]) -> List[Any]:
    """Gather picklable python objects from every process, concatenated in
    rank order (reference: ddp_utils.all_gather_list). Payloads may differ
    in length: ``all_gather_object`` pickles each rank's list. Under NCCL
    it stages the bytes on the current CUDA device, so each rank must have
    called ``torch.cuda.set_device`` on its own card first
    (``mesh.initialize_multihost`` does)."""
    if process_count() == 1:
        return list(items)
    gathered: List[Any] = [None] * process_count()
    dist.all_gather_object(gathered, list(items))
    return [x for part in gathered for x in part]


def sync_hosts(name: str = "barrier") -> None:
    """Barrier over every process (reference: run_on_master_first /
    dist.barrier); ``name`` labels it for the logs only."""
    if process_count() == 1:
        return
    dist.barrier()


def sharded_iterator(iterable, num_shards: int, shard_index: int) -> Iterator:
    """mod-N sample sharding (reference: ddp_utils.py:50-69)."""
    for i, item in enumerate(iterable):
        if i % num_shards == shard_index:
            yield item


def sharded_batch_iterator(iterable, batch_size: int, num_shards: int,
                           shard_index: int) -> Iterator[List]:
    """Batches of this shard's samples, each as (global index, sample)."""
    batch: List = []
    for i, item in enumerate(iterable):
        if i % num_shards == shard_index:
            batch.append((i, item))
            if len(batch) == batch_size:
                yield batch
                batch = []
    if batch:
        yield batch

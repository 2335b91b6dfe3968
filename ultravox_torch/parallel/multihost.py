"""Per-process data feeding for multi-process runs.

As in the JAX package, every process loads its own mod-N shard of the
samples (reference ddp_utils.py:50-69) and collates its own rows of the
global batch. The JAX package then pads every host to the global maxima
(text length, mel length, chunk count) and offsets the chunks' row index,
because one global ``jax.Array`` needs one shape. Here each process runs
its rows on its own device as they are: the global batch exists only as
the union of the processes' rows, and the loss makes it one batch by
normalising each process's sum by the count over all of them
(``models/ultravox.py``). Ragged processes give the same numbers as the
JAX package's padded global batch.
"""

from __future__ import annotations


class ShardedDataset:
    """Re-iterable mod-N sample shard of a dataset (reference:
    ddp_utils.sharded_iterator, kept re-startable so infinite epoch cycling
    in ``batch_iterator`` works)."""

    def __init__(self, dataset, num_shards: int, shard_index: int):
        self.dataset = dataset
        self.num_shards = num_shards
        self.shard_index = shard_index

    def __iter__(self):
        for i, item in enumerate(self.dataset):
            if i % self.num_shards == self.shard_index:
                yield item

    def __len__(self):
        n = len(self.dataset)
        return (n - self.shard_index + self.num_shards - 1) // self.num_shards

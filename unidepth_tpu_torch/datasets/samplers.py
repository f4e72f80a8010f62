"""Evaluation sampling across processes (a copy of
unidepth_tpu/datasets/samplers.py): process p of P takes indices p, p + P,
p + 2P, ... with no wrap-around, so no sample is counted twice and the
metrics stay exact (the reference's DistributedSamplerNoDuplicate).
"""

from __future__ import annotations


class ShardedEvalSampler:
    def __init__(self, length: int, num_shards: int, shard_id: int):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.length = length
        self.num_shards = num_shards
        self.shard_id = shard_id

    def __iter__(self):
        return iter(range(self.shard_id, self.length, self.num_shards))

    def __len__(self):
        return (self.length - self.shard_id + self.num_shards - 1) // self.num_shards

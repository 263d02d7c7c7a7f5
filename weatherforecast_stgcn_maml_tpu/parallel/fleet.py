"""Region-fleet partitioning for multi-host runs.

Regional adaptation jobs are independent (the reference runs them serially,
main.py:30); across a multi-host deployment each host takes a partition
of the region list and all hosts share checkpoints through the filesystem —
no collective communication is needed. `auto_shard()` picks the
partition from the JAX process topology so the same pipeline command
works on 1 or N hosts.
"""

from __future__ import annotations


def partition_round_robin(items, num_shards: int, shard_id: int):
    """Deterministic round-robin partition (balanced to within one item)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} out of range [0, {num_shards})")
    return [x for i, x in enumerate(items) if i % num_shards == shard_id]


def auto_shard() -> tuple[int, int]:
    """(shard_id, num_shards) from the JAX multi-host process topology."""
    import jax

    return jax.process_index(), jax.process_count()

"""In-process data-parallel workers (the counterpart of the reference's
``shard_map`` over the ``data`` mesh axis).

``p`` workers run in one process as a loop over contiguous batch shards —
worker ``w`` gets rows ``[w * B/p, (w+1) * B/p)``, exactly the slice
``batch_shard_specs`` gives data shard ``w`` — and the collectives are
plain tensor ops over the per-worker values, in worker order.  A
``torch.distributed`` backend with one process per card is a later slice.
"""
from __future__ import annotations

import torch


def shard_batch(batch: dict, n: int) -> list[dict]:
    """Split every (B, ...) entry into ``n`` contiguous (B/n, ...) shards."""
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % n:
        raise ValueError(f"batch rows {sizes} not divisible by {n} workers")
    b = next(iter(sizes)) // n
    return [{k: v[w * b:(w + 1) * b] for k, v in batch.items()}
            for w in range(n)]


def all_gather(items: list) -> torch.Tensor:
    """Stack one array per worker -> (n, ...) in worker order."""
    return torch.stack(items)


def pmean(items: list) -> torch.Tensor:
    """Mean over workers: the sum in worker order, divided by ``n``."""
    total = items[0].float()
    for x in items[1:]:
        total = total + x
    return total / len(items)

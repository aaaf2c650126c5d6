"""Data-parallel workers and their collectives (the counterpart of the
reference's ``shard_map`` over the ``data`` and ``pod`` mesh axes).

A :class:`WorkerGroup` holds ``p`` workers laid over the ranks of a
`repro_torch.launch.mesh.RankLayout`: this process runs the ``p / N``
contiguous workers of its rank, one after another.  Worker ``w`` gets
batch rows ``[w * B/p, (w+1) * B/p)``, exactly the slice
``batch_shard_specs`` gives data shard ``w``.  With one rank (``N = 1``) the
group is the in-process loop over all ``p`` workers and the collectives are
plain tensor ops.  With more, they go through ``torch.distributed``:

* :meth:`WorkerGroup.all_gather` stacks every worker's tensor into
  ``(p, ...)`` in worker order;
* :meth:`WorkerGroup.worker_sum` and :meth:`WorkerGroup.pmean` (and a
  :class:`WorkerSum` fed one local worker at a time) add every worker's
  tensor on every rank in worker order, so their bits do not depend on
  ``N`` (an all-reduce would add in the order its ring or tree takes).
  One process keeps a running sum; over ranks the local tensors are
  gathered first.

The tensors cross the wire as raw bytes, whatever their dtype.  ``nccl``
gathers on the rank's card (a leaf asked for on the host moves there
after).  ``gloo`` moves every tensor through one host buffer the group
keeps (page-locked when the rank runs on a card), always the same way,
and sends each rank's rows to every other rank with point-to-point
messages: on an H100 host, 512 MB a rank, gloo's ring all-gather ran at
0.556-0.631 GB/s a rank and the paired sends at 1.048-1.170
(``tools/gloo_gather_rates.py``; PERF.md section 6).  The group
counts what each rank sends by ``repro.analysis.audit``'s byte model, under
the reference's name for the collective: a gather its output (``p`` times
one worker's payload), a ``psum`` (the sums and means) twice one worker's
payload.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import RankLayout

# bytes a gloo message carries at most
_CHUNK_BYTES = 1 << 26


def shard_batch(batch: dict, n: int) -> list[dict]:
    """Split every (B, ...) entry into ``n`` contiguous (B/n, ...) shards."""
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % n:
        raise ValueError(f"batch rows {sizes} not divisible by {n} workers")
    b = next(iter(sizes)) // n
    return [{k: v[w * b:(w + 1) * b] for k, v in batch.items()}
            for w in range(n)]


class WorkerGroup:
    """``n_workers`` data-parallel workers over the ranks of ``layout``
    (default: one process).  ``local`` are the ids of this rank's workers;
    every per-worker list a method takes holds one entry per local worker,
    in worker order."""

    def __init__(self, n_workers: int, layout: RankLayout | None = None):
        layout = layout or RankLayout()
        if n_workers < 1 or n_workers % layout.world:
            raise ValueError(f"{n_workers} workers cannot be split evenly "
                             f"over {layout.world} ranks")
        self.n, self.layout = n_workers, layout
        self.local = layout.local_workers(n_workers)
        self.wire: dict[str, dict] = {}
        self._stage = None          # gloo's host buffer, grown on demand

    @property
    def n_local(self) -> int:
        return len(self.local)

    @property
    def distributed(self) -> bool:
        return self.layout.world > 1

    # -- wire accounting ---------------------------------------------------
    def reset_wire(self) -> None:
        self.wire = {}

    def wire_bytes(self) -> int:
        return sum(v["bytes"] for v in self.wire.values())

    def _count(self, kind: str, n_bytes: int) -> None:
        slot = self.wire.setdefault(kind, {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += n_bytes

    # -- collectives -------------------------------------------------------
    def shard_batch(self, batch: dict) -> list[dict]:
        """The local workers' shards of the global batch, which every rank
        draws whole from the same seed."""
        shards = shard_batch(batch, self.n)
        return [shards[w] for w in self.local]

    def all_gather(self, items: list) -> torch.Tensor:
        """One tensor per local worker -> ``(p, ...)`` in worker order."""
        local = torch.stack(items)
        self._count("all_gather", local.nbytes * self.layout.world)
        return self.gather_rows(local) if self.distributed else local

    def worker_sum(self, items: list) -> torch.Tensor:
        """The float32 sum over all ``p`` workers of one tensor each (one
        per local worker, in the dtype it crosses the wire in), added in
        worker order on every rank."""
        acc = WorkerSum(self)
        for x in items:
            acc.add(x)
        return acc.total()

    def pmean(self, items: list) -> torch.Tensor:
        """Mean over all workers: :meth:`worker_sum` divided by ``p``."""
        return self.worker_sum(items) / self.n

    def gather_rows(self, local: torch.Tensor,
                    device: torch.device | None = None) -> torch.Tensor:
        """This rank's ``(p / N, ...)`` rows -> every rank's, ``(p, ...)``
        in worker order, on ``device`` (default ``local``'s).  Uncounted:
        the callers above count the wire."""
        world = self.layout.world
        device = local.device if device is None else device
        shape = (world * local.shape[0],) + tuple(local.shape[1:])
        src = local.contiguous().reshape(-1).view(torch.uint8)
        if self.layout.backend == "nccl":
            # nccl gathers on the rank's card; the whole leaf moves on
            out = torch.empty(shape, dtype=local.dtype, device=local.device)
            dist.all_gather_into_tensor(
                out.view(-1).view(torch.uint8).view(world, -1), src)
            return out.to(device)
        out = torch.empty(shape, dtype=local.dtype, device=device)
        dst = out.view(-1).view(torch.uint8).view(world, -1)
        n, rank = src.numel(), self.layout.rank
        rows = self._host_rows(world, n, src.is_cuda)
        rows[rank].copy_(src)
        works = []
        for peer in range(world):
            if peer == rank:
                continue
            for tag, a in enumerate(range(0, n, _CHUNK_BYTES)):
                b = min(n, a + _CHUNK_BYTES)
                works.append(dist.isend(rows[rank, a:b], peer, tag=tag))
                works.append(dist.irecv(rows[peer, a:b], peer, tag=tag))
        for work in works:
            work.wait()
        dst.copy_(rows)
        return out

    def _host_rows(self, world: int, n: int, pinned: bool) -> torch.Tensor:
        """A ``(world, n)`` byte view of the group's host buffer."""
        if self._stage is None or self._stage.numel() < world * n:
            self._stage = None
            self._stage = torch.empty(world * n, dtype=torch.uint8,
                                      pin_memory=pinned)
        return self._stage[:world * n].view(world, n)


class WorkerSum:
    """The float32 sum over all ``p`` workers of one tensor a worker, fed
    one local worker at a time, in worker order (:meth:`add`), and read
    once (:meth:`total`).  One process keeps a running sum, so at most one
    sum and one worker's tensor are alive whatever ``p`` is; over ranks the
    local tensors are kept, in the dtype they cross the wire in, until
    :meth:`total` gathers every worker's.  Both add the same values in the
    same order.  The tensors fed are never written to."""

    def __init__(self, group: WorkerGroup):
        self.group, self._rows = group, []
        self._sum, self._own, self._nbytes = None, False, 0

    def add(self, x: torch.Tensor) -> None:
        if self.group.distributed:
            self._rows.append(x)
        elif self._sum is None:
            self._sum, self._own = x.float(), x.dtype != torch.float32
            self._nbytes = x.nbytes
        elif self._own:
            self._sum.add_(x)
        else:                       # the first tensor fed is the caller's
            self._sum, self._own = self._sum + x, True

    def total(self) -> torch.Tensor:
        group = self.group
        if group.distributed:
            rows = list(group.gather_rows(torch.stack(self._rows)))
            self._nbytes, self._rows = self._rows[0].nbytes, []
            self._sum, self._own = rows[0].float(), True
            for x in rows[1:]:
                self._sum = self._sum + x
        if self._sum is None:
            raise ValueError("no worker fed the sum")
        group._count("psum", 2 * self._nbytes)
        return self._sum

    def mean(self, p: int | None = None) -> torch.Tensor:
        """:meth:`total` divided by ``p`` (default the group's), in place
        where the sum is not a tensor that was fed."""
        total, p = self.total(), p or self.group.n
        return total.div_(p) if self._own else total / p


def as_group(workers) -> WorkerGroup:
    """A :class:`WorkerGroup`, or an int: that many in-process workers."""
    return workers if isinstance(workers, WorkerGroup) \
        else WorkerGroup(int(workers))

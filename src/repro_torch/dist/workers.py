"""Data-parallel workers and their collectives (the counterpart of the
reference's ``shard_map`` over the ``data`` and ``pod`` mesh axes).

A :class:`WorkerGroup` holds ``p`` workers laid over the data ranks of a
`repro_torch.launch.mesh.RankLayout`: this process runs the ``p / N``
contiguous workers of its data rank, one after another (``N`` data ranks;
under ``--model-shards m`` the ``m`` ranks of a model group run the same
workers on their model shards, and the group's collectives run among the
ranks of one model index).  Worker ``w`` gets
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

The tensors cross the wire as raw bytes, whatever their dtype
(`repro_torch.launch.mesh.Exchange`).  ``nccl`` gathers on the rank's card
(a leaf asked for on the host moves there after).  ``gloo`` moves every
tensor through one host buffer, always the same way, and sends each rank's
rows to every other data rank with point-to-point messages that name the
peers' global ranks: on an H100 host, 512 MB a rank, gloo's ring
all-gather ran at 0.556-0.631 GB/s a rank and the paired sends at
1.048-1.170 (``tools/gloo_gather_rates.py``; PERF.md section 6).  The group
counts what each rank sends by ``repro.analysis.audit``'s byte model, under
the reference's name for the collective: a gather its output (``p`` times
one worker's payload), a ``psum`` (the sums and means) twice one worker's
payload; the model group's sums and gathers
(`repro_torch.models.actx.ModelGroup`) count under ``model_psum`` and
``model_all_gather`` beside them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist  # noqa: F401  (the collectives' module)

from repro_torch.launch.mesh import Exchange, RankLayout, process_group


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
        if n_workers < 1 or n_workers % layout.data_world:
            raise ValueError(f"{n_workers} workers cannot be split evenly "
                             f"over {layout.data_world} ranks")
        self.n, self.layout = n_workers, layout
        self.local = layout.local_workers(n_workers)
        self.wire: dict[str, dict] = {}
        self._exchange = Exchange(layout, layout.data_peers(),
                                  process_group("data"))

    @property
    def n_local(self) -> int:
        return len(self.local)

    @property
    def distributed(self) -> bool:
        """Whether the workers are laid over more than one data rank."""
        return self.layout.data_world > 1

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
        self._count("all_gather", local.nbytes * self.layout.data_world)
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
        """This rank's ``(p / N, ...)`` rows -> every data rank's, ``(p,
        ...)`` in worker order, on ``device`` (default ``local``'s).
        Uncounted: the callers above count the wire."""
        return self._exchange.gather_rows(local, device)


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

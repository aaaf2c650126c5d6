"""The rank layout of the port's data-parallel workers (counterpart of
``repro.launch.mesh``).

The reference lays its ``p`` workers over the ``("pod", "data")`` axes of a
device mesh and runs each step body inside ``shard_map``.  The port runs
them as ``N`` processes ("ranks") of one ``torch.distributed`` process
group, ``p / N`` contiguous workers a rank: worker ``w`` lives on rank
``w // (p / N)``, the pod-major order of the reference's two data axes
flattened.  ``N = 1`` is one process and no process group.

:func:`make_host_mesh` starts the process group from an explicit backend,
world size, rank and a ``FileStore`` file (no TCP port), with a finite
collective timeout, so a dead peer ends every wait with an error.
:func:`check_layout` refuses a layout its backend cannot serve: ``nccl``
runs one rank a card and raises when there are fewer visible cards than
ranks; it never falls back to ``gloo``.  ``gloo`` may put several ranks on
one card (:func:`rank_device`).

The production mesh (the reference's ``make_production_mesh``, 256 or 512
chips) is not ported: it waits for the port's dry-run slice.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# seconds a collective (and the store's rendezvous) waits for its peers
COLLECTIVE_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class RankLayout:
    """This process's place among ``world`` ranks; ``backend`` is empty
    for one process without a process group."""

    world: int = 1
    rank: int = 0
    backend: str = ""

    def local_workers(self, n_workers: int) -> range:
        """The ids of the workers this rank runs, in worker order: worker
        ``w`` runs on rank ``w // (n_workers / world)``."""
        per = n_workers // self.world
        return range(self.rank * per, (self.rank + 1) * per)


def default_backend(device_type: str) -> str:
    """``nccl`` on the card, ``gloo`` on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def check_layout(n_workers: int, world: int, backend: str,
                 device_type: str) -> None:
    """Raise ``ValueError`` unless ``n_workers`` can run over ``world``
    ranks of ``backend`` on ``device_type`` devices."""
    if world < 1 or n_workers < 1 or n_workers % world:
        raise ValueError(f"{n_workers} workers cannot be split evenly over "
                         f"{world} ranks (--ranks must divide --workers)")
    if world == 1:
        return
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if device_type == "cuda" else 0
        if cards < world:
            raise ValueError(
                f"nccl runs one rank a card: {world} ranks, {cards} visible "
                f"{device_type} cards; name gloo to share a card (or run on "
                "the CPU)")


def rank_device(layout: RankLayout, device_type: str) -> torch.device:
    """The device rank ``layout.rank`` runs on: the CPU, its own card
    (``nccl``) or card ``rank % cards`` (``gloo``, which may share one)."""
    if device_type != "cuda":
        return torch.device(device_type)
    cards = torch.cuda.device_count()
    if layout.backend == "nccl" and layout.rank >= cards:
        raise ValueError(f"nccl rank {layout.rank} has no card of its own "
                         f"({cards} visible)")
    return torch.device("cuda", layout.rank % cards)


def make_host_mesh(*, backend: str, world: int, rank: int,
                   store_path: str) -> RankLayout:
    """Join the process group of ``world`` ranks as ``rank`` through the
    ``FileStore`` at ``store_path`` (every rank passes the same path; the
    file must not exist before the first rank starts).  One rank starts no
    process group."""
    if world == 1:
        return RankLayout()
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        backend, store=store, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return RankLayout(world, rank, backend)


def close(layout: RankLayout) -> None:
    """Leave the process group :func:`make_host_mesh` joined."""
    if layout.world > 1 and dist.is_initialized():
        dist.destroy_process_group()

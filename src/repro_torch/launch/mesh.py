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

With ``model = m > 1`` (``--model-shards``) the ``N`` ranks form a grid
of ``N / m`` data ranks by ``m`` model ranks, the model index innermost as
in the reference's ``("data", "model")`` device order: rank ``r`` is data
rank ``r // m`` and model rank ``r % m``.  The workers are laid over the
data ranks; the ``m`` ranks of one data rank (a *model group*) hold the
model shards of its workers (`repro_torch.models.actx`).
:func:`make_host_mesh` creates every model group, then every data group,
in the same order on every rank.  :class:`Exchange` gathers raw bytes over
one such group.

:func:`make_production_mesh` is the reference's production layout (256
or 512 cards) as a layout only, with no process group: the dry run
(`repro_torch.launch.dryrun`) traces rank 0 of it.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# seconds a collective (and the store's rendezvous) waits for its peers
COLLECTIVE_TIMEOUT_S = 300.0
# bytes a gloo message carries at most
_CHUNK_BYTES = 1 << 26
# this process's model and data process groups (make_host_mesh, m > 1)
_GROUPS: dict = {}


@dataclass(frozen=True)
class RankLayout:
    """This process's place among ``world`` ranks; ``backend`` is empty
    for one process without a process group."""

    world: int = 1
    rank: int = 0
    backend: str = ""
    model: int = 1

    @property
    def data_world(self) -> int:
        return self.world // self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def data_peers(self) -> list[int]:
        """The global ranks of this rank's data group, in data order."""
        return [d * self.model + self.model_rank
                for d in range(self.data_world)]

    def model_peers(self) -> list[int]:
        """The global ranks of this rank's model group, in model order."""
        return [self.data_rank * self.model + j for j in range(self.model)]

    def local_workers(self, n_workers: int) -> range:
        """The ids of the workers this rank runs, in worker order: worker
        ``w`` runs on data rank ``w // (n_workers / data_world)``."""
        per = n_workers // self.data_world
        return range(self.data_rank * per, (self.data_rank + 1) * per)


@dataclass(frozen=True)
class ProductionMesh:
    """A device layout without devices or a process group: the axes'
    names, outermost first, and their sizes (the model axis innermost, as
    the reference's ``("data", "model")`` device order)."""

    shape: tuple
    axis_names: tuple

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The reference's production mesh: (data 16, model 16), 256 cards;
    multi-pod (pod 2, data 16, model 16), 512, the ``pod`` axis an outer
    data-parallel axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ProductionMesh(shape, axes)


def default_backend(device_type: str) -> str:
    """``nccl`` on the card, ``gloo`` on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def check_layout(n_workers: int, world: int, backend: str,
                 device_type: str, model: int = 1) -> None:
    """Raise ``ValueError`` unless ``n_workers`` can run over ``world``
    ranks of ``backend`` on ``device_type`` devices, ``model`` ranks to a
    model group."""
    if model < 1 or world % model:
        raise ValueError(f"--model-shards {model} must divide --ranks "
                         f"{world}")
    data = world // model
    if n_workers < 1 or n_workers % data:
        what = ("--ranks must divide --workers" if model == 1 else
                "--ranks / --model-shards must divide --workers")
        raise ValueError(f"{n_workers} workers cannot be split evenly over "
                         f"{data} data ranks ({what})")
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
                   store_path: str, model: int = 1) -> RankLayout:
    """Join the process group of ``world`` ranks as ``rank`` through the
    ``FileStore`` at ``store_path`` (every rank passes the same path; the
    file must not exist before the first rank starts).  One rank starts no
    process group.  With ``model > 1`` every rank then creates the model
    groups in data order and the data groups in model order, keeping its
    own (:func:`process_group`)."""
    if world == 1:
        return RankLayout()
    store = dist.FileStore(store_path, world)
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=timeout)
    layout = RankLayout(world, rank, backend, model)
    _GROUPS.clear()
    if model > 1:
        data = world // model
        for kind, members in (
                [("model", [d * model + j for j in range(model)])
                 for d in range(data)]
                + [("data", [d * model + j for d in range(data)])
                   for j in range(model)]):
            # every rank creates every group, members or not
            pg = dist.new_group(members, timeout=timeout) \
                if len(members) > 1 else None
            if rank in members:
                _GROUPS[kind] = pg
    return layout


def process_group(kind: str):
    """This rank's ``"model"`` or ``"data"`` process group; ``None`` (the
    whole world) without model groups."""
    return _GROUPS.get(kind)


def close(layout: RankLayout) -> None:
    """Leave the process group :func:`make_host_mesh` joined."""
    _GROUPS.clear()
    if layout.world > 1 and dist.is_initialized():
        dist.destroy_process_group()


class Exchange:
    """Gathers of raw bytes over ``peers`` (global ranks, this rank among
    them) of ``layout``'s backend, through the process group ``group``
    (``None``: the whole world).  ``nccl`` gathers on the rank's card (a
    leaf asked for elsewhere moves there after).  ``gloo`` moves every
    tensor through one host buffer the exchange keeps (page-locked when
    the rank runs on a card), always the same way, and sends this rank's
    rows to every other peer with point-to-point messages."""

    def __init__(self, layout: RankLayout, peers: list[int], group=None):
        self.layout, self.peers, self.group = layout, list(peers), group
        self.index = self.peers.index(layout.rank)
        self._stage = None          # gloo's host buffer, grown on demand

    def gather_rows(self, local: torch.Tensor,
                    device: torch.device | None = None) -> torch.Tensor:
        """This rank's ``(n, ...)`` rows -> every peer's, ``(len(peers) *
        n, ...)`` in peer order, on ``device`` (default ``local``'s)."""
        world = len(self.peers)
        device = local.device if device is None else device
        shape = (world * local.shape[0],) + tuple(local.shape[1:])
        src = local.contiguous().reshape(-1).view(torch.uint8)
        if self.layout.backend == "nccl":
            # nccl gathers on the rank's card; the whole leaf moves on
            out = torch.empty(shape, dtype=local.dtype, device=local.device)
            dst = out.view(-1).view(torch.uint8).view(world, -1)
            if self.group is None:
                dist.all_gather_into_tensor(dst, src)
            else:
                dist.all_gather_into_tensor(dst, src, group=self.group)
            return out.to(device)
        out = torch.empty(shape, dtype=local.dtype, device=device)
        dst = out.view(-1).view(torch.uint8).view(world, -1)
        n, me = src.numel(), self.index
        rows = self._host_rows(world, n, src.is_cuda)
        rows[me].copy_(src)
        works = []
        for i, peer in enumerate(self.peers):
            if i == me:
                continue
            for tag, a in enumerate(range(0, n, _CHUNK_BYTES)):
                b = min(n, a + _CHUNK_BYTES)
                works.append(dist.isend(rows[me, a:b], peer, tag=tag,
                                        group=self.group))
                works.append(dist.irecv(rows[i, a:b], peer, tag=tag,
                                        group=self.group))
        for work in works:
            work.wait()
        dst.copy_(rows)
        return out

    def _host_rows(self, world: int, n: int, pinned: bool) -> torch.Tensor:
        """A ``(world, n)`` byte view of the exchange's host buffer."""
        if self._stage is None or self._stage.numel() < world * n:
            self._stage = None
            self._stage = torch.empty(world * n, dtype=torch.uint8,
                                      pin_memory=pinned)
        return self._stage[:world * n].view(world, n)

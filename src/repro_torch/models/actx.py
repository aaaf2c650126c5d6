"""The model group's context: tensor parallelism's collectives (counterpart
of ``repro.models.actx``).

The reference marks the Megatron constraint points of its model code with
``constrain(x, kind)`` and lets GSPMD place the collectives over the
``model`` mesh axis.  The port runs the ``m`` model shards as ``m``
processes, a *model group* (`repro_torch.launch.mesh`), and places the
collectives by hand at the same points.  The launcher installs a
:class:`ModelGroup` (:func:`install`); without one every operator here is
the identity, so the CPU tests and every ``--model-shards 1`` path never
touch it.

* :func:`copy_in` is Megatron's ``f``: identity forward, a sum over the
  model group backward.  It goes before a column-parallel product (the
  reference's ``attn_q`` / ``attn_kv``, ``ffn_hidden`` and ``logits``
  points), and on a replicated leaf that only head-local activations use
  (``q_norm``, ``k_norm``), whose gradient is partial on each rank.
* :func:`reduce_out` is Megatron's ``g``: a sum over the model group
  forward, identity backward.  It goes after a row-parallel product
  (``wo``, ``w_down``) and after the vocab-parallel lookup.
* :func:`gather_leaf` gathers a model-sharded leaf that a layer uses
  whole (or an activation sharded on a dim, as RWKV6's channel-mix gate);
  its backward takes this rank's slice of the whole gradient, which every
  rank computes alike.
* :func:`psum` is a sum over the model group forward *and* backward: a
  partial value every rank then uses on its own shard, as a norm's sum of
  squares over a sharded dim (Mamba2's ``gate_norm``, RWKV6's ``ln_x``),
  whose gradient is partial on each rank too.
* :func:`vocab_parallel_nll` is the cross entropy of vocab-sharded logits:
  a max over the group, then the sums of exponentials and the target
  logits, without gathering the (B, S, V) logits.

Every sum is a gather, then a sum in model-rank order in f32, cast back to
the summed tensor's dtype: the same bits on every rank of the group, so
the replicated activations and leaves never drift apart, whatever order
the messages arrive in.  The collectives run inside autograd's backward;
every rank builds the same graph, so they meet in the same order.
"""
from __future__ import annotations

import torch

_CTX = None


def model_dim(spec) -> int | None:
    """The dim a param spec shards over ``model`` (``None``: replicated)."""
    for i, s in enumerate(tuple(spec)):
        if s is not None:
            return i
    return None


class ModelGroup:
    """This rank's model group of ``layout`` (`repro_torch.launch.mesh`):
    ``size`` ranks, this one at ``rank``.  ``count(kind, n_bytes)`` (e.g.
    a `WorkerGroup`'s) receives the bytes of each counted collective by
    ``repro.analysis.audit``'s byte model: a sum twice its payload, a
    gather its output."""

    def __init__(self, layout, count=None):
        from repro_torch.launch.mesh import Exchange, process_group
        self.size, self.rank = layout.model, layout.model_rank
        self.backend = layout.backend
        self._ex = Exchange(layout, layout.model_peers(),
                            process_group("model"))
        self._world = Exchange(layout, list(range(layout.world)))
        self._count = count

    def _counted(self, kind: str, n_bytes: int) -> None:
        if self._count is not None:
            self._count(kind, n_bytes)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(size, *x.shape)``: every rank's ``x``, in model order."""
        self._counted("model_all_gather", x.nbytes * self.size)
        return self._ex.gather_rows(x.unsqueeze(0))

    def gather_dim(self, x: torch.Tensor, dim: int, device=None,
                   counted: bool = True) -> torch.Tensor:
        """Every rank's ``x`` joined along ``dim`` in model order, on
        ``device`` (default ``x``'s)."""
        if counted:
            self._counted("model_all_gather", x.nbytes * self.size)
        whole = self._ex.gather_rows(x.movedim(dim, 0), device)
        return whole.movedim(0, dim)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` in model order, in f32, cast to
        ``x``'s dtype."""
        self._counted("model_psum", 2 * x.nbytes)
        parts = self._ex.gather_rows(x.unsqueeze(0))
        acc = parts[0].float()
        for part in parts[1:]:
            acc = acc + part
        return acc.to(x.dtype)

    def _flag(self, flag: bool, device) -> torch.Tensor:
        # nccl gathers on the card
        return torch.tensor([1 if flag else 0], dtype=torch.uint8,
                            device=device if self.backend == "nccl"
                            else "cpu")

    def group_all(self, flag: bool, device=None) -> bool:
        """Whether ``flag`` holds on every rank of the model group
        (``device``: the rank's card, under nccl)."""
        return bool(self._ex.gather_rows(self._flag(flag, device)).all())

    def world_all(self, flag: bool, device=None) -> bool:
        """Whether ``flag`` holds on every rank of the world."""
        return bool(self._world.gather_rows(self._flag(flag, device)).all())


def install(ctx: ModelGroup | None) -> None:
    """Make ``ctx`` the model group of every operator here (``None``:
    none, every operator the identity)."""
    global _CTX
    _CTX = ctx


def current() -> ModelGroup | None:
    return _CTX


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.sum(grad), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.sum(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.sum(grad), None


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n, ctx.group = dim, x.shape[dim], group
        return group.gather_dim(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n), None, \
            None


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """Megatron's ``f``: identity forward, model-group sum backward."""
    return x if _CTX is None else _CopyIn.apply(x, _CTX)


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    """Megatron's ``g``: model-group sum forward, identity backward."""
    return x if _CTX is None else _ReduceOut.apply(x, _CTX)


def psum(x: torch.Tensor) -> torch.Tensor:
    """A model-group sum forward and backward (both counted as
    ``model_psum``)."""
    return x if _CTX is None else _Psum.apply(x, _CTX)


def gather_leaf(x: torch.Tensor, dim: int | None) -> torch.Tensor:
    """The whole leaf (or activation) of this rank's slice ``x`` sharded on
    ``dim`` (``None``: ``x`` is whole already)."""
    if _CTX is None or dim is None:
        return x
    return _GatherLeaf.apply(x, dim, _CTX)


class _VocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, start, group):
        v = logits.shape[-1]
        peak = group.gather(logits.amax(dim=-1)).amax(dim=0)
        e = torch.exp(logits - peak[..., None])
        total = group.sum(e.sum(dim=-1))
        local = labels - start
        inside = (local >= 0) & (local < v)
        local = torch.where(inside, local, torch.zeros_like(local))
        picked = torch.gather(logits, -1, local[..., None])[..., 0]
        target = group.sum(torch.where(inside, picked,
                                       torch.zeros_like(picked)))
        ctx.save_for_backward(e.div_(total[..., None]), local, inside)
        return torch.log(total) + peak - target

    @staticmethod
    def backward(ctx, grad):
        probs, local, inside = ctx.saved_tensors
        out = probs * grad[..., None]
        hit = torch.where(inside, grad, torch.zeros_like(grad))
        out.scatter_add_(-1, local[..., None], -hit[..., None])
        return out, None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       start: int) -> torch.Tensor:
    """Per-token negative log-likelihood (B, S) of f32 logits sharded on
    the vocab, this rank's (B, S, V / m) holding vocab ids ``[start, start
    + V / m)``."""
    return _VocabParallelNLL.apply(logits, labels.long(), start, _CTX)


def model_total(sharded: torch.Tensor, replicated: torch.Tensor):
    """A sum over every entry of the whole model from this rank's part of
    it: ``sharded`` (over its shards of the sharded leaves) summed over
    the model group, plus ``replicated`` (over the leaves every rank holds
    whole), counted once."""
    return _CTX.sum(sharded) + replicated

"""Parameter declarations (counterpart of ``repro.models.params``).

Models declare parameters as trees of :class:`ParamDef` (shape, init,
logical axis names).  Each leaf keeps the reference's *stacked* layout —
one tensor per parameter with a leading ``n_layers`` dim — because the
compressors act per leaf: the top-k of ``w_gate`` is taken over all its
layers at once, and splitting the leaf would change which entries win.

Spec resolution maps logical axes to the ``model`` mesh axis exactly as the
reference does, and, for the dry run, the FSDP data axes
(``fsdp_axes``); :func:`shard_shape` is one device's shard of a leaf and
:func:`abstract_params` the tree on the ``meta`` device.  At a model axis of 1 every spec is all-``None``; under
``--model-shards m`` a rank holds model rank ``j``'s slice of each leaf its
spec shards (`repro_torch.dist.sharding.shard_leaf`), and
:func:`init_params` / :func:`params_from_jax` draw or read each whole leaf
and keep that slice, so a run's params do not depend on the layout.

Serving holds every matrix in the compute dtype
(:func:`init_serving_params`): each use of a matrix casts it to bf16 first,
so bf16-held leaves give bitwise the same operands as f32-held ones, at
half the memory.  Vectors (norm scales; Mamba2's ``a_log``, ``dt_bias``,
``d_skip`` and conv biases; RWKV6's ``decay_bias``) stay f32, and so does a
matrix that the model uses in f32 (``serve_f32``: RWKV6's ``bonus_u``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import tree as T

MODEL_AXIS_PRIORITY = (
    "experts", "vocab", "heads", "kv_heads", "ff", "dinner", "state", "embed",
)
# logical axes eligible for FSDP (data-axis) sharding, after the model axis
FSDP_AXIS_CANDIDATES = (
    "embed", "ff", "dinner", "vocab", "heads", "kv_heads", "experts",
)


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple
    init: str = "normal"          # normal | zeros | ones | constant
    scale: float | None = None    # normal: stddev (None => 1/sqrt fan_in)
    constant: float = 0.0
    serve_f32: bool = False       # held f32 for serving (used in f32)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    def materialize(self, gen: torch.Generator, device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, device=device)
        if self.init == "constant":
            return torch.full(self.shape, self.constant, device=device)
        if self.init == "normal":
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            std = self.scale if self.scale is not None else fan_in ** -0.5
            x = torch.randn(self.shape, generator=gen, device=device)
            return x.mul_(std)
        raise ValueError(self.init)


def stack_defs(defs, n: int):
    """Add a leading stacked-layers dim of size ``n`` to every ParamDef."""
    return T.tree_map(
        lambda d: dataclasses.replace(d, shape=(n, *d.shape),
                                      axes=("layers", *d.axes)), defs)


def resolve_spec(d: ParamDef, axis_sizes: dict,
                 fsdp_axes: tuple = ()) -> tuple:
    """Logical axes -> mesh axis per dim, as the reference's
    ``resolve_spec``: ``"model"`` on the highest-priority divisible dim,
    then (``fsdp_axes``, e.g. ``("data",)``) the data axes on the largest
    remaining eligible dim (one name, or a tuple of several); ``None``
    elsewhere."""
    model_size = axis_sizes.get("model", 1)
    fsdp_size = math.prod(axis_sizes.get(a, 1) for a in fsdp_axes)
    spec = [None] * len(d.shape)
    if model_size > 1:
        ranked = sorted(
            (i for i, ax in enumerate(d.axes) if ax in MODEL_AXIS_PRIORITY),
            key=lambda i: MODEL_AXIS_PRIORITY.index(d.axes[i]))
        for i in ranked:
            if d.shape[i] % model_size == 0 and d.shape[i] >= model_size:
                spec[i] = "model"
                break
    if fsdp_size > 1 and fsdp_axes:
        cands = [i for i, ax in enumerate(d.axes)
                 if ax in FSDP_AXIS_CANDIDATES and spec[i] is None
                 and d.shape[i] % fsdp_size == 0
                 and d.shape[i] >= fsdp_size]
        if cands:
            i = max(cands, key=lambda i: d.shape[i])
            spec[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    return tuple(spec)


def param_specs(defs, axis_sizes: dict | None = None, fsdp_axes: tuple = ()):
    return T.tree_map(lambda d: resolve_spec(d, axis_sizes or {}, fsdp_axes),
                      defs)


def shard_shape(shape: tuple, spec, axis_sizes: dict) -> tuple:
    """The shape of one device's shard of a ``shape`` leaf under ``spec``
    (each sharded dim divided by the product of its axes' sizes)."""
    out = []
    for n, s in zip(shape, tuple(spec)):
        names = () if s is None else ((s,) if isinstance(s, str) else s)
        out.append(n // math.prod(axis_sizes.get(a, 1) for a in names))
    return tuple(out)


def abstract_params(defs, device="meta"):
    """The ParamDef tree as float32 tensors on the ``meta`` device (the
    reference's ``ShapeDtypeStruct`` stand-ins): shapes and dtypes, no
    storage."""
    return T.tree_map(
        lambda d: torch.empty(d.shape, dtype=torch.float32, device=device),
        defs)


def init_params(defs, gen: torch.Generator, device=None, *, specs=None,
                rank: int = 0, size: int = 1):
    """Materialize a ParamDef tree (float32) from one generator, leaves
    drawn in leaf order.  For standalone runs: the reference draws from
    ``jax.random``, whose numbers torch cannot reproduce, so parity tests
    carry the reference's params over with :func:`params_from_jax`.  With
    ``specs`` and ``size > 1`` each leaf is drawn whole, one at a time, and
    model rank ``rank``'s slice of it kept."""
    device = device if device is not None else gen.device
    if specs is None or size == 1:
        return T.tree_map(lambda d: d.materialize(gen, device), defs)
    return T.tree_map(
        lambda d, sp: _keep_slice(d.materialize(gen, device), sp, rank, size),
        defs, specs)


def _keep_slice(x: torch.Tensor, spec, rank: int, size: int):
    from repro_torch.dist.sharding import shard_leaf
    part = shard_leaf(x, spec, rank, size)
    return part if part is x else part.clone()


def _is_matrix(d: ParamDef) -> bool:
    """A leaf of two or more dims per layer (not a norm scale) that the
    model casts to the compute dtype at each use."""
    per_layer = len(d.shape) - (d.axes[:1] == ("layers",))
    return per_layer >= 2 and not d.serve_f32


def init_serving_params(defs, gen: torch.Generator, device=None):
    """Materialize a ParamDef tree for serving: matrices in bfloat16,
    vectors in float32, leaves drawn in leaf order.  A stacked leaf is drawn
    layer by layer into its preallocated tensor, so no float32 copy of a
    whole stacked leaf ever exists (``w_gate`` of mixtral-8x7b at 24
    layers is 11.3 G entries, 45 GB in float32)."""
    device = device if device is not None else gen.device

    def draw(d: ParamDef) -> torch.Tensor:
        dt = torch.bfloat16 if _is_matrix(d) else torch.float32
        if d.axes[:1] != ("layers",):
            return d.materialize(gen, device).to(dt)
        one = dataclasses.replace(d, shape=d.shape[1:], axes=d.axes[1:])
        out = torch.empty(d.shape, dtype=dt, device=device)
        for i in range(d.shape[0]):
            out[i].copy_(one.materialize(gen, device))
        return out

    return T.tree_map(draw, defs)


def count_params(defs) -> int:
    """Entries in a ParamDef tree (the reference's ``count_params``)."""
    return sum(math.prod(d.shape) for d in T.leaves(defs))


def params_from_jax(tree_of_numpy, device="cpu", *, specs=None,
                    rank: int = 0, size: int = 1):
    """The reference's parameters (a nested dict of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as float32 torch tensors; with
    ``specs`` and ``size > 1``, model rank ``rank``'s slice of each."""
    def one(a, spec=None):
        x = torch.as_tensor(np.array(a, dtype=np.float32))
        if spec is not None:
            x = _keep_slice(x, spec, rank, size)
        return x.to(device)

    if specs is None or size == 1:
        return T.tree_map(one, tree_of_numpy)
    return T.tree_map(one, tree_of_numpy, specs)


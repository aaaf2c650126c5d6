"""The weights of a run, made by the benchmark from the seed and handed to
both sides: the program under test and the plain reference.

Each leaf has a generator of its own, seeded from ``(seed, leaf index)``,
so a leaf can be drawn again alone (the check of the parameters' change
does so after the third step) and is drawn in one call, on the device, in
float32, the type the training state holds.  Norm scales are ones; every
matrix is normal with standard deviation ``fan_in ** -0.5``, where
``fan_in`` is the dimension a product contracts: ``d_model`` for the
embedding, the head and every input projection, the heads' width for the
attention's output projection, and the feed-forward width for the down
projections.
"""
from __future__ import annotations

import numpy as np

ONES = ("final_norm", "ln_attn", "ln_mlp", "q_norm", "k_norm")


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit seed for leaf ``index`` of a run seeded with ``seed``."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def fan_in(path: str, shape: tuple, d_model: int) -> int:
    name = path.split("/")[-1]
    if name == "wo":                  # (..., heads, head_dim, d)
        return shape[-3] * shape[-2]
    if name == "w_down":              # (..., ff, d)
        return shape[-2]
    return d_model


def leaf(path: str, shape: tuple, index: int, seed: int, device,
         d_model: int):
    """Leaf ``index`` (at ``path``, of ``shape``) of the run's weights."""
    import torch

    if path.split("/")[-1] in ONES:
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.normal_(0.0, fan_in(path, shape, d_model) ** -0.5,
                       generator=gen)


def make(paths, shapes, seed: int, device, d_model: int) -> list:
    """Every leaf, in the order of ``paths``."""
    return [leaf(p, tuple(s), i, seed, device, d_model)
            for i, (p, s) in enumerate(zip(paths, shapes))]

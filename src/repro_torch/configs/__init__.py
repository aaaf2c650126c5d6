"""Architecture config registry: ``get_config("<arch-id>")``.

The port runs the uniform-window attention stack, dense or MoE, and the
Mamba2 stack with its shared attention block: the registry holds
qwen3-1.7b (trained), mixtral-8x7b and zamba2-7b (served);
``"<id>-smoke"`` gives an entry's ``reduced()`` variant.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2

REGISTRY: dict[str, ArchConfig] = {c.name: c
                                   for c in [_mixtral, _qwen3, _zamba2]}

ARCH_IDS = tuple(REGISTRY) + tuple(f"{n}-smoke" for n in REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke") and name[: -len("-smoke")] in REGISTRY:
        return REGISTRY[name[: -len("-smoke")]].reduced()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCH_IDS)}")
    return REGISTRY[name]

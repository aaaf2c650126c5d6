"""Architecture config registry: ``get_config("<arch-id>")``.

The port runs the dense attention stack, so the registry holds the one
architecture of that kind; ``"<id>-smoke"`` gives its ``reduced()`` variant.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in [_qwen3]}

ARCH_IDS = tuple(REGISTRY) + tuple(f"{n}-smoke" for n in REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke") and name[: -len("-smoke")] in REGISTRY:
        return REGISTRY[name[: -len("-smoke")]].reduced()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCH_IDS)}")
    return REGISTRY[name]

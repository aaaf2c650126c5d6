"""Architecture config registry: ``get_config("<arch-id>")``.

The registry holds every one of the reference's ten configs, in its order:
the attention stack, dense or MoE (qwen3-1.7b, mistral-nemo-12b,
mixtral-8x7b with a uniform window, gemma3-27b's local:global pattern,
moonshot-v1-16b-a3b's 64 experts and grok-1-314b), with the vision
(internvl2-2b) or audio (musicgen-large) frontend stub; the Mamba2 stack
with zamba2's shared attention block; and the RWKV6 stack.
``"<id>-smoke"`` gives an entry's ``reduced()`` variant.
"""
from __future__ import annotations

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig,  # noqa: F401
                                      InputShape)
from repro_torch.configs.gemma3_27b import CONFIG as _gemma3
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2

REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in [_musicgen, _internvl2, _grok, _moonshot, _zamba2,
                        _rwkv6, _nemo, _mixtral, _qwen3, _gemma3]}

ARCH_IDS = tuple(REGISTRY) + tuple(f"{n}-smoke" for n in REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke") and name[: -len("-smoke")] in REGISTRY:
        return REGISTRY[name[: -len("-smoke")]].reduced()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCH_IDS)}")
    return REGISTRY[name]

"""Architecture config registry: ``get_config("<arch-id>")``.

The port runs three stack kinds: the attention stack, dense or MoE, with a
uniform window or gemma3's local:global pattern; the Mamba2 stack with
zamba2's shared attention block; and the RWKV6 stack.  The registry holds
qwen3-1.7b and rwkv6-1.6b (trained), mixtral-8x7b, zamba2-7b, gemma3-27b
and mistral-nemo-12b (served); ``"<id>-smoke"`` gives an entry's
``reduced()`` variant.  The vision and audio frontends (internvl2-2b,
musicgen-large), moonshot-v1-16b-a3b and grok-1-314b are not ported yet.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs.gemma3_27b import CONFIG as _gemma3
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2

REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in [_zamba2, _rwkv6, _nemo, _mixtral, _qwen3, _gemma3]}

ARCH_IDS = tuple(REGISTRY) + tuple(f"{n}-smoke" for n in REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke") and name[: -len("-smoke")] in REGISTRY:
        return REGISTRY[name[: -len("-smoke")]].reduced()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCH_IDS)}")
    return REGISTRY[name]

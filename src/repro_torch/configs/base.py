"""Architecture configuration (counterpart of ``repro.configs.base``).

The dataclass carries every field of the reference's ``ArchConfig`` so a
parity test can compare the two field by field; the port runs the
attention stack (``block_type == "attn"``), dense or MoE, with a uniform
window or gemma3's local:global pattern and the vision or audio frontend
stub, the Mamba2 stack (``"mamba2"``) with or without the shared attention
block, and the RWKV6 stack (``"rwkv6"``).  ``InputShape`` and
``INPUT_SHAPES`` are the reference's workloads, as plain data.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

BLOCK_ATTN = "attn"
BLOCK_MAMBA2 = "mamba2"
BLOCK_RWKV6 = "rwkv6"

FRONTEND_NONE = "none"
FRONTEND_AUDIO = "audio"
FRONTEND_VISION = "vision"


@dataclass(frozen=True)
class ArchConfig:
    """Complete architecture description (backbone only for audio/vlm)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    sliding_window: int = 0
    global_every: int = 0
    rope_theta: float = 1e4
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_d_ff: int = 0
    # --- SSM (mamba2 / rwkv6) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0
    # --- stack composition ---
    block_type: str = BLOCK_ATTN
    # --- modality frontend ---
    frontend: str = FRONTEND_NONE
    n_prefix_embeds: int = 0
    n_codebooks: int = 0
    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.n_heads == 0:
            return 0
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def attention_free(self) -> bool:
        return (self.block_type in (BLOCK_MAMBA2, BLOCK_RWKV6)
                and self.shared_attn_every == 0)

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports long_500k (SSM / hybrid / windowed
        attention)."""
        if self.block_type in (BLOCK_MAMBA2, BLOCK_RWKV6):
            return True
        return self.sliding_window > 0

    def layer_window_sizes(self) -> list[int]:
        """Per-layer attention window (0 = full/global) for attn stacks."""
        out = []
        for i in range(self.n_layers):
            if self.sliding_window and self.global_every:
                out.append(0 if (i + 1) % self.global_every == 0
                           else self.sliding_window)
            elif self.sliding_window:
                out.append(self.sliding_window)
            else:
                out.append(0)
        return out

    def param_count(self) -> int:
        """Analytic parameter count, term for term the reference's: the
        attention stack (dense or MoE), the Mamba2 stack with its shared
        attention block (the reference leaves out the Mamba2 dt, conv and
        per-head leaves, and the norm scales of the shared block) and the
        RWKV6 stack (the reference's term counts 6 d^2 + 1.5 d d_ff + 2 d a
        layer, not the 7 d^2 + 2 d d_ff of its leaves: ``count_params``
        counts those)."""
        d, v = self.d_model, self.vocab_size
        n = v * d if self.tie_embeddings else 2 * v * d
        hd = self.resolved_head_dim
        if self.block_type == BLOCK_MAMBA2:
            di = self.ssm_expand * d
            per_layer = d * (2 * di + 2 * self.ssm_state) + di * d + 2 * d
        elif self.block_type == BLOCK_RWKV6:
            per_layer = 6 * d * d + 3 * d * self.d_ff // 2 + 2 * d
        else:
            per_layer = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                         + self.n_heads * hd * d + 2 * d)
            if self.is_moe:
                per_layer += (self.n_experts * 3 * d * self.expert_d_ff
                              + d * self.n_experts)
            else:
                per_layer += 3 * d * self.d_ff
        n += self.n_layers * per_layer
        if self.shared_attn_every:
            n += 4 * d * d + 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the routed experts)."""
        if not self.is_moe:
            return self.param_count()
        per_layer_expert = 3 * self.d_model * self.expert_d_ff
        inactive = (self.n_layers * (self.n_experts - self.experts_per_token)
                    * per_layer_expert)
        return self.param_count() - inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU tests (2 layers, d_model<=128)."""
        d = min(self.d_model, 128)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads) if self.n_kv_heads else 0
        if self.block_type == BLOCK_RWKV6:
            ssm_state, ssm_heads = 16, d // 16
        else:
            ssm_state = min(self.ssm_state, 16) if self.ssm_state else 0
            ssm_heads = min(self.ssm_heads, 4) if self.ssm_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=d,
            d_ff=min(self.d_ff, 4 * d),
            moe_d_ff=min(self.expert_d_ff, 2 * d) if self.is_moe else 0,
            vocab_size=min(self.vocab_size, 512),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d // n_heads if n_heads else 0,
            n_experts=min(self.n_experts, 4) if self.is_moe else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.is_moe else 0),
            ssm_state=ssm_state,
            ssm_heads=ssm_heads,
            sliding_window=(min(self.sliding_window, 32)
                            if self.sliding_window else 0),
            global_every=self.global_every,
            shared_attn_every=self.shared_attn_every,
            n_prefix_embeds=(min(self.n_prefix_embeds, 8)
                             if self.n_prefix_embeds else 0),
        )


@dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) workload."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

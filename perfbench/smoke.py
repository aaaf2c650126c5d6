"""A cell cut to the program's ``-smoke`` sizes, for the CPU tests and a
rehearsal without the card: the same traffic at a sequence of 32, on the
program's small configuration of the same family, with limits of its
own.

At these sizes (2 layers, d 128) one rounding flip weighs more than at
the published widths: over seeds 1-4 of qwen3-1.7b-smoke, mixtral-8x7b-
smoke and moonshot-v1-16b-a3b-smoke on the CPU (the async cell at its
six checked steps), sound runs read ``grad1_gap`` up to 7.7e-4 and
``change_gap`` up to 5.1e-3, and the control (float8 operands) at least
6.6e-3 and 5.7e-3.
"""
from __future__ import annotations

from perfbench import harness

SMOKE_LIMITS = {"grad1_gap": 3e-3, "change_gap": 1.5e-2}


def smoke_config(port: str) -> dict:
    """A configuration file's keys for ``<port>-smoke``."""
    from repro_torch.configs import get_config

    c = get_config(port + "-smoke")
    conf = {"port_config": port + "-smoke",
            "model_type": "qwen3" if c.qk_norm else "mixtral",
            "hidden_size": c.d_model, "intermediate_size": c.d_ff,
            "num_attention_heads": c.n_heads,
            "num_key_value_heads": c.n_kv_heads,
            "head_dim": c.resolved_head_dim, "num_hidden_layers": c.n_layers,
            "vocab_size": c.vocab_size, "rms_norm_eps": c.norm_eps,
            "rope_theta": c.rope_theta,
            "tie_word_embeddings": c.tie_embeddings, "sliding_window": None}
    if c.is_moe:
        conf.update(num_local_experts=c.n_experts,
                    num_experts_per_tok=c.experts_per_token,
                    moe_intermediate_size=c.expert_d_ff,
                    router_aux_loss_coef=c.router_aux_weight)
    return conf


def smoke_cell(cell: str, port: str, seq: int = 32) -> dict:
    out = harness.load_cell(cell)
    out["config_file"] = smoke_config(port)
    out["traffic_file"] = dict(out["traffic_file"], seq=seq)
    out["limits"] = dict(SMOKE_LIMITS)
    return out

"""A configuration file's shapes, read the same way by the harness (which
hands them to the program's config) and by the plain reference.

A file holds the published ``config.json`` keys of the model as they are
run (those cut for the chip listed under ``reduced``), the program's
config id (``port_config``) and the sizes the source does not fix
(``assumed``).
"""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def dims(conf: dict) -> dict:
    """The shapes and constants both sides build from."""
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    experts = conf.get("num_local_experts", conf.get("n_routed_experts", 0))
    moe_ff = conf.get("moe_intermediate_size", conf["intermediate_size"])
    assumed = conf.get("assumed", {})
    return {
        "d_model": d,
        "n_heads": h,
        "n_kv_heads": conf["num_key_value_heads"],
        "head_dim": conf.get("head_dim") or d // h,
        "d_ff": conf["intermediate_size"],
        "expert_d_ff": moe_ff if experts else 0,
        "vocab_size": conf["vocab_size"],
        "n_layers": conf["num_hidden_layers"],
        "norm_eps": float(conf["rms_norm_eps"]),
        "rope_theta": float(conf["rope_theta"]),
        "tie_embeddings": bool(conf["tie_word_embeddings"]),
        "qk_norm": conf["model_type"] == "qwen3",
        "sliding_window": conf.get("sliding_window") or 0,
        "n_experts": experts,
        "experts_per_token": conf.get("num_experts_per_tok", 0)
        if experts else 0,
        "router_aux_weight": float(conf.get("router_aux_loss_coef", 0.0)),
        "capacity_factor": float(assumed.get("capacity_factor", 1.25)),
        "routing_group": int(assumed.get("routing_group", 512)),
    }

"""Plain forward pass and loss of the benchmark's decoder models.

A pre-norm decoder: RMSNorm, rotary attention with grouped key-value heads
(RoPE on the two halves of each head; Qwen3's RMSNorm on each query and key
head), then a gated SiLU MLP, or a mixture of experts routed GShard-style
(softmax router, top-k renormalised, each expert holding
``capacity_factor`` times its even share of a token group, tokens past it
dropped; a Switch load-balancing loss weighted by the router coefficient).
The LM head is the embedding's transpose when tied.

Precision, as the configuration states it: the parameters are float32;
activations are bfloat16 between operations; every matrix product takes
its two operands through ``quant`` (bfloat16 for the model as configured,
or the control's lower precision) and accumulates in float32; the
attention scores, the softmax, the LM head's logits and the loss are
float32 on those operands.

The parameters are a dict from leaf path to a float32 tensor, the
per-layer leaves stacked on a leading layer dim (:func:`leaf_shapes`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16


def leaf_shapes(dm: dict) -> dict:
    """Leaf path -> shape, in sorted path order."""
    d, v, n = dm["d_model"], dm["vocab_size"], dm["n_layers"]
    h, k, hd = dm["n_heads"], dm["n_kv_heads"], dm["head_dim"]
    out = {"embed": (v, d), "final_norm": (d,),
           "layers/attn/wq": (n, d, h, hd), "layers/attn/wk": (n, d, k, hd),
           "layers/attn/wv": (n, d, k, hd), "layers/attn/wo": (n, h, hd, d),
           "layers/ln_attn": (n, d), "layers/ln_mlp": (n, d)}
    if dm["qk_norm"]:
        out["layers/attn/q_norm"] = (n, hd)
        out["layers/attn/k_norm"] = (n, hd)
    if dm["n_experts"]:
        e, ff = dm["n_experts"], dm["expert_d_ff"]
        out.update({"layers/moe/router": (n, d, e),
                    "layers/moe/w_gate": (n, e, d, ff),
                    "layers/moe/w_up": (n, e, d, ff),
                    "layers/moe/w_down": (n, e, ff, d)})
    else:
        ff = dm["d_ff"]
        out.update({"layers/mlp/w_gate": (n, d, ff),
                    "layers/mlp/w_up": (n, d, ff),
                    "layers/mlp/w_down": (n, ff, d)})
    if not dm["tie_embeddings"]:
        out["lm_head"] = (d, v)
    return dict(sorted(out.items()))


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's operand: rounded to float8 e4m3 under a per-tensor
    scale (largest magnitude to 448), carried in bfloat16; the gradient
    passes straight through."""
    xd = x.detach().float()
    scale = 448.0 / xd.abs().amax().clamp(min=1e-30)
    q = (xd * scale).to(torch.float8_e4m3fn).float() / scale
    return (x.float() + (q - xd)).to(BF16)


def rmsnorm(x, scale, eps):
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(BF16)


def rope(x, theta):
    """x (B, S, H, D) bf16: rotate the two halves of D by position."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device),
                          torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(BF16)


def attention(p, i, dm, x, quant):
    """Causal grouped-query attention of layer ``i`` on x (B, S, d)."""
    q = torch.einsum("bsd,dhk->bshk", quant(x), quant(p["layers/attn/wq"][i]))
    k = torch.einsum("bsd,dhk->bshk", quant(x), quant(p["layers/attn/wk"][i]))
    v = torch.einsum("bsd,dhk->bshk", quant(x), quant(p["layers/attn/wv"][i]))
    if dm["qk_norm"]:
        q = rmsnorm(q, p["layers/attn/q_norm"][i], dm["norm_eps"])
        k = rmsnorm(k, p["layers/attn/k_norm"][i], dm["norm_eps"])
    q, k = rope(q, dm["rope_theta"]), rope(k, dm["rope_theta"])
    group = dm["n_heads"] // dm["n_kv_heads"]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    s = x.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * dm["head_dim"] ** -0.5
    pos = torch.arange(s, device=x.device)
    allowed = pos[:, None] >= pos[None, :]
    if dm["sliding_window"]:
        allowed &= (pos[:, None] - pos[None, :]) < dm["sliding_window"]
    scores = scores.masked_fill(~allowed, -1e30)
    probs = torch.softmax(scores, dim=-1).to(BF16)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(BF16)
    return torch.einsum("bshk,hkd->bsd", quant(out),
                        quant(p["layers/attn/wo"][i]))


def mlp(p, i, x, quant):
    gate = F.silu(quant(x) @ quant(p["layers/mlp/w_gate"][i]))
    up = quant(x) @ quant(p["layers/mlp/w_up"][i])
    return quant(gate * up) @ quant(p["layers/mlp/w_down"][i])


def route(logits, top_k: int, cap: int):
    """GShard routing of (G, T, E) logits: (dispatch (G, T, E, C), combine
    (G, T, E, C), balance loss).  The top ``top_k`` experts of each token
    by a stable descending sort (the lower index wins a tie), their
    weights renormalised; choice j of token t takes the next free slot of
    its expert in (token, choice) order, and is dropped past ``cap``."""
    g, t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    choice = torch.argsort(-probs, dim=-1, stable=True)[..., :top_k]
    weight = torch.gather(probs, -1, choice)
    weight = weight / weight.sum(-1, keepdim=True)
    onehot = F.one_hot(choice, e)                              # (G, T, k, E)
    balance = torch.mean(torch.mean(probs, dim=1)
                         * torch.mean(onehot.sum(2).float(), dim=1)) * e * e
    flat = onehot.reshape(g, t * top_k, e)
    slot = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1)
    slot = slot.reshape(g, t, top_k)
    kept = slot < cap
    slots = F.one_hot(torch.where(kept, slot, cap), cap + 1)[..., :cap]
    slots = slots.float() * kept[..., None].float()            # (G, T, k, C)
    sel = onehot.float()
    dispatch = torch.einsum("gtke,gtkc->gtec", sel, slots)
    combine = torch.einsum("gtk,gtke,gtkc->gtec", weight, sel, slots)
    return dispatch, combine, balance


def moe(p, i, dm, x, quant):
    b, s, d = x.shape
    e, top_k = dm["n_experts"], dm["experts_per_token"]
    tokens = x.reshape(-1, d)
    size = min(dm["routing_group"], tokens.shape[0])
    groups = tokens.reshape(-1, size, d)
    logits = torch.einsum("gtd,de->gte", quant(groups),
                          quant(p["layers/moe/router"][i]))
    cap = max(4, -(-int(size * top_k * dm["capacity_factor"] / e) // 4) * 4)
    dispatch, combine, balance = route(logits, top_k, cap)
    xe = torch.einsum("gtec,gtd->egcd", dispatch.to(BF16), quant(groups))
    gate = F.silu(torch.einsum("egcd,edf->egcf", quant(xe),
                               quant(p["layers/moe/w_gate"][i])))
    up = torch.einsum("egcd,edf->egcf", quant(xe),
                      quant(p["layers/moe/w_up"][i]))
    out = torch.einsum("egcf,efd->egcd", quant(gate * up),
                       quant(p["layers/moe/w_down"][i]))
    y = torch.einsum("egcd,gtec->gtd", out, combine.to(BF16))
    return y.reshape(b, s, d), balance


def loss(p, dm, tokens, labels, quant=bf16):
    """Mean next-token cross entropy plus the weighted balance loss."""
    eps = dm["norm_eps"]
    x = p["embed"][tokens].to(BF16)
    balance = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(dm["n_layers"]):
        x = x + attention(p, i, dm, rmsnorm(x, p["layers/ln_attn"][i], eps),
                          quant)
        y = rmsnorm(x, p["layers/ln_mlp"][i], eps)
        if dm["n_experts"]:
            out, b = moe(p, i, dm, y, quant)
            balance = balance + b
        else:
            out = mlp(p, i, y, quant)
        x = x + out
    x = rmsnorm(x, p["final_norm"], eps)
    head = p["embed"].t() if dm["tie_embeddings"] else p["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", quant(x).float(),
                          quant(head).float())
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None]).mean()
    return ce + dm["router_aux_weight"] * balance

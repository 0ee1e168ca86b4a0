"""The Llama stack: CSM-1B's backbone, and CSM's decoder whatever the
backbone is.

Each layer: RMSNorm, grouped-query attention with RoPE (q, k, v, o; every
layer holds a KV cache), RMSNorm, a SwiGLU MLP (gate, up, down); a final
RMSNorm. The plain reference is `reference/llama.py`.
"""

from __future__ import annotations

import dataclasses

from gpubench.reference import llama as plain


def spec(prefix: tuple, cfg: dict) -> list:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    attn = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    out = []
    for i in range(cfg["num_hidden_layers"]):
        lp = prefix + ("layers", i)
        for name, (o, n) in (("q_proj", (attn, d)), ("k_proj", (kv, d)),
                             ("v_proj", (kv, d)), ("o_proj", (d, attn))):
            out.append((lp + ("self_attn", name, "weight"), (o, n), "randn",
                        n ** -0.5))
        for name, (o, n) in (("gate_proj", (f, d)), ("up_proj", (f, d)),
                             ("down_proj", (d, f))):
            out.append((lp + ("mlp", name, "weight"), (o, n), "randn",
                        n ** -0.5))
        for name in ("input_layernorm", "post_attention_layernorm"):
            out.append((lp + (name, "weight"), (d,), "ones", 1.0))
    out.append((prefix + ("norm", "weight"), (d,), "ones", 1.0))
    return out


def port_config(cfg: dict):
    from csm_mlx_tpu_torch.config import LlamaConfig, RopeScalingConfig

    c = {k: v for k, v in cfg.items() if k != "arch"}
    unknown = sorted(set(c) - {f.name for f in dataclasses.fields(
        LlamaConfig)})
    if unknown:
        raise SystemExit(f"LlamaConfig has no field {unknown}")
    scaling = c.pop("rope_scaling", None)
    return LlamaConfig(
        rope_scaling=RopeScalingConfig(**scaling) if scaling else None, **c)


def reference(params: dict, cfg: dict, bits: int) -> plain.Stack:
    return plain.Stack(params, cfg, bits)


def linears(cfg: dict) -> list:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    attn = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    return [[("qkv", d, attn + 2 * kv), ("o", attn, d), ("gate-up", d, 2 * f),
             ("down", f, d)] for _ in range(cfg["num_hidden_layers"])]


def attention_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"]


def decode_ops(cfg: dict, context: float) -> float:
    return _linear_ops(cfg) + _attn_ops(cfg, context)


def prefill_ops(cfg: dict, rows: int) -> float:
    """Causal attention: rows * (rows + 1) / 2 query-key pairs."""
    return rows * _linear_ops(cfg) + _attn_ops(cfg, rows * (rows + 1) / 2)


def _linear_ops(cfg: dict) -> float:
    """One position through every layer's linears."""
    return 2.0 * sum(i * o for layer in linears(cfg) for _, i, o in layer)


def _attn_ops(cfg: dict, keys: float) -> float:
    """Scores and the weighted sum of `keys` query-key pairs in every
    layer."""
    attn = cfg["num_attention_heads"] * cfg["head_dim"]
    return 4.0 * cfg["num_hidden_layers"] * attn * keys

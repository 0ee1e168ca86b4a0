"""Mimi codec transformer, batch mode (port of `csm_mlx_tpu/models/mimi/transformer.py`).

Pre-LN layers with LayerNorm (weight + bias), HALF-SPLIT (rotate-half)
RoPE with theta 10k — unlike the pair-interleaved CSM rope —, layer scales
on both residual branches, an exact-GELU MLP without biases, and causal
attention limited to a sliding window of `cfg.sliding_window` keys. The
streaming ring KV cache is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from csm_mlx_tpu_torch.device import resolve_device
from csm_mlx_tpu_torch.models.mimi.config import MimiConfig
from csm_mlx_tpu_torch.ops.attention import NEG_INF, sdpa
from csm_mlx_tpu_torch.ops.layers import linear

Params = Dict[str, Any]


def layer_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).pow(2).mean(dim=-1, keepdim=True)
    out = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    out = out * p["weight"].to(x.dtype)
    if "bias" in p:
        out = out + p["bias"].to(x.dtype)
    return out


def _rope_half(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split RoPE in fp32. x: (B, S, H, D); positions: (B, S)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = positions.float()[..., None] * inv  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :d // 2], xf[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attn(p: Params, cfg: MimiConfig, x: torch.Tensor,
          positions: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q = _rope_half(linear(p["q_proj"], x).reshape(b, s, h, d), positions,
                   cfg.rope_theta)
    k = _rope_half(linear(p["k_proj"], x).reshape(b, s, hkv, d), positions,
                   cfg.rope_theta)
    v = linear(p["v_proj"], x).reshape(b, s, hkv, d)
    out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               scale=d ** -0.5, mask_bias=mask_bias)
    return linear(p["o_proj"], out.transpose(1, 2).reshape(b, s, h * d))


def transformer_forward(params: Params, cfg: MimiConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) latent sequence -> (B, S, D)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q_pos = torch.arange(s, device=x.device)[:, None]
    k_pos = torch.arange(s, device=x.device)[None, :]
    ok = (k_pos <= q_pos) & (k_pos > q_pos - cfg.sliding_window)
    mask_bias = torch.where(ok, 0.0, NEG_INF).float()[None, None]
    for lp in params["layers"]:
        h = layer_norm(lp["input_layernorm"], x, cfg.norm_eps)
        attn = _attn(lp["self_attn"], cfg, h, positions, mask_bias)
        x = x + attn * lp["self_attn_layer_scale"]["scale"].to(x.dtype)
        h = layer_norm(lp["post_attention_layernorm"], x, cfg.norm_eps)
        mlp = linear(lp["mlp"]["fc2"],
                     F.gelu(linear(lp["mlp"]["fc1"], h), approximate="none"))
        x = x + mlp * lp["mlp_layer_scale"]["scale"].to(x.dtype)
    return x


def init_transformer_params(generator: torch.Generator, cfg: MimiConfig,
                            dtype=torch.float32,
                            device: torch.device | str | None = None
                            ) -> Params:
    device = resolve_device(device)
    d = cfg.hidden_size

    def dense(o, i):
        w = torch.randn((o, i), generator=generator, device=device,
                        dtype=torch.float32)
        return {"weight": (w * i ** -0.5).to(dtype)}

    def full(value):
        return torch.full((d,), value, dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
            "self_attn": {
                "q_proj": dense(cfg.num_attention_heads * cfg.head_dim, d),
                "k_proj": dense(cfg.num_key_value_heads * cfg.head_dim, d),
                "v_proj": dense(cfg.num_key_value_heads * cfg.head_dim, d),
                "o_proj": dense(d, cfg.num_attention_heads * cfg.head_dim),
            },
            "mlp": {"fc1": dense(cfg.intermediate_size, d),
                    "fc2": dense(d, cfg.intermediate_size)},
            "input_layernorm": {"weight": full(1.0), "bias": full(0.0)},
            "post_attention_layernorm": {"weight": full(1.0),
                                         "bias": full(0.0)},
            "self_attn_layer_scale": {
                "scale": full(cfg.layer_scale_initial_scale)},
            "mlp_layer_scale": {"scale": full(cfg.layer_scale_initial_scale)},
        })
    return {"layers": layers}

"""Mimi codec transformer (port of `csm_mlx_tpu/models/mimi/transformer.py`).

Pre-LN layers with LayerNorm (weight + bias), HALF-SPLIT (rotate-half)
RoPE with theta 10k — unlike the pair-interleaved CSM rope —, layer scales
on both residual branches, an exact-GELU MLP without biases, and causal
attention limited to a sliding window of `cfg.sliding_window` keys.

Two modes: batch (the full-sequence sliding-window mask) and streaming
over a `RingKVCache` of window + slack slots with absolute positions, so a
stream runs O(window) a frame forever. The ring's buffers, its index (a
() int32 tensor) and its per-row starts are UPDATED IN PLACE, unlike the
JAX cache that each call returns anew: a step captured in a CUDA graph
then writes and advances the same ring at every replay.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

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


@dataclasses.dataclass
class RingKVCache:
    """Sliding-window KV cache: slot = position % window.

    k, v: (L, B, H_kv, W, D); index: () int32, the absolute next position
    (all rows share it: one batched stream); start: (B,) int32, the first
    absolute position each row may attend to — a row recycled for a new
    stream (`mimi.reset_decode_row`) must not see its predecessor's keys;
    rotary attention is relative, so masking keys below `start` makes the
    row a fresh stream begun there."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor
    start: torch.Tensor

    @staticmethod
    def init(cfg: MimiConfig, batch: int, dtype=torch.float32,
             slack: int = 8,
             device: torch.device | str = "cpu") -> "RingKVCache":
        """W = sliding_window + slack slots: a chunk of S <= slack new
        tokens then never overwrites a slot that an older query of the same
        chunk still attends to (transformer_forward raises past it)."""
        shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
                 cfg.sliding_window + slack, cfg.head_dim)
        return RingKVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            index=torch.zeros((), dtype=torch.int32, device=device),
            start=torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def window(self) -> int:
        return self.k.shape[3]


def _attn(p: Params, cfg: MimiConfig, x: torch.Tensor,
          positions: torch.Tensor, mask_bias: torch.Tensor,
          cache: Optional[RingKVCache] = None, layer: int = 0,
          slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, s, _ = x.shape
    h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q = _rope_half(linear(p["q_proj"], x).reshape(b, s, h, d), positions,
                   cfg.rope_theta)
    k = _rope_half(linear(p["k_proj"], x).reshape(b, s, hkv, d), positions,
                   cfg.rope_theta)
    v = linear(p["v_proj"], x).reshape(b, s, hkv, d)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if cache is not None:
        # the S new tokens go to slots (index + t) % W, in place
        cache.k[layer].index_copy_(2, slots, k.to(cache.k.dtype))
        cache.v[layer].index_copy_(2, slots, v.to(cache.v.dtype))
        k, v = cache.k[layer], cache.v[layer]
    out = sdpa(q, k, v, scale=d ** -0.5, mask_bias=mask_bias)
    return linear(p["o_proj"], out.transpose(1, 2).reshape(b, s, h * d))


def _ring_mask_bias(cfg: MimiConfig, cache: RingKVCache,
                    positions: torch.Tensor, s: int) -> torch.Tensor:
    """(B, 1, S, W) bias of the ring's slots, shared by every layer. Slot j
    holds position j + W * floor((last - j) / W), last = index + S - 1 the
    newest; a query at q sees it iff q - window < p <= q and p >= start."""
    w = cache.window
    last = cache.index.long() + s - 1
    j = torch.arange(w, device=positions.device)
    p_slot = (j + w * torch.div(last - j, w, rounding_mode="floor"))[None, None]
    q = positions[:, :, None]
    valid = (p_slot <= q) & (p_slot > q - cfg.sliding_window) & (
        p_slot >= cache.start.long()[:, None, None])
    return torch.where(valid, 0.0, NEG_INF).float()[:, None]


def transformer_forward(params: Params, cfg: MimiConfig, x: torch.Tensor,
                        cache: Optional[RingKVCache] = None) -> torch.Tensor:
    """x: (B, S, D) latent sequence -> (B, S, D). Without a cache the
    sliding-window causal mask over the sequence; with one, the S tokens
    continue the stream in the ring, which is written and advanced by S in
    place."""
    b, s, _ = x.shape
    device = x.device
    slots = None
    if cache is None:
        positions = torch.arange(s, device=device)[None].expand(b, s)
        q_pos = torch.arange(s, device=device)[:, None]
        k_pos = torch.arange(s, device=device)[None, :]
        ok = (k_pos <= q_pos) & (k_pos > q_pos - cfg.sliding_window)
        mask_bias = torch.where(ok, 0.0, NEG_INF).float()[None, None]
    else:
        if s > cache.window - cfg.sliding_window:
            # a longer chunk would overwrite slots its own earliest queries
            # still attend to
            raise ValueError(
                f"streaming chunk of {s} tokens exceeds the ring slack "
                f"({cache.window - cfg.sliding_window}); feed shorter chunks "
                f"or use the batch path")
        steps = cache.index.long() + torch.arange(s, device=device)
        positions = steps[None].expand(b, s)
        mask_bias = _ring_mask_bias(cfg, cache, positions, s)
        slots = steps % cache.window
    for i, lp in enumerate(params["layers"]):
        h = layer_norm(lp["input_layernorm"], x, cfg.norm_eps)
        attn = _attn(lp["self_attn"], cfg, h, positions, mask_bias, cache, i,
                     slots)
        x = x + attn * lp["self_attn_layer_scale"]["scale"].to(x.dtype)
        h = layer_norm(lp["post_attention_layernorm"], x, cfg.norm_eps)
        mlp = linear(lp["mlp"]["fc2"],
                     F.gelu(linear(lp["mlp"]["fc1"], h), approximate="none"))
        x = x + mlp * lp["mlp_layer_scale"]["scale"].to(x.dtype)
    if cache is not None:
        cache.index.add_(s)
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

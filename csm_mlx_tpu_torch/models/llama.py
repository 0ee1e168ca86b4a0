"""Llama transformer stack over embeddings (port of `csm_mlx_tpu/models/llama.py`).

Parameters are nested dicts with the checkpoint's names:
params["layers"][i]["self_attn"]["q_proj"]["weight"], ...,
params["norm"]["weight"]. The forward consumes embeddings (B, S, D): CSM
builds its fused text+audio input outside the stack.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from csm_mlx_tpu_torch.config import LlamaConfig
from csm_mlx_tpu_torch.device import resolve_device
from csm_mlx_tpu_torch.ops import layers, tensor_parallel
from csm_mlx_tpu_torch.ops.attention import (flash_decode_sdpa,
                                             flash_prefill_sdpa, sdpa)
from csm_mlx_tpu_torch.ops.flash_train import flash_attention
from csm_mlx_tpu_torch.ops.kv_cache import KVCache
from csm_mlx_tpu_torch.ops.layers import linear, rms_norm, swiglu_mlp
from csm_mlx_tpu_torch.ops.rope import apply_rope

Params = Dict[str, Any]


def init_llama_params(generator: torch.Generator, cfg: LlamaConfig,
                      dtype=torch.float32,
                      device: torch.device | str | None = None) -> Params:
    """Random init, normal / sqrt(fan_in), drawn from `generator` on
    `device` (default `cuda`); layout identical to checkpoints."""
    device = resolve_device(device)
    d = cfg.hidden_size
    kv_dim = cfg.num_key_value_heads * cfg.head_dim
    f = cfg.intermediate_size

    def dense(out_dim, in_dim):
        w = torch.randn((out_dim, in_dim), generator=generator,
                        device=device, dtype=torch.float32)
        return {"weight": (w * in_dim ** -0.5).to(dtype)}

    def ones():
        return {"weight": torch.ones((d,), dtype=dtype, device=device)}

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
            "self_attn": {
                "q_proj": dense(cfg.attn_dim, d),
                "k_proj": dense(kv_dim, d),
                "v_proj": dense(kv_dim, d),
                "o_proj": dense(d, cfg.attn_dim),
            },
            "mlp": {
                "gate_proj": dense(f, d),
                "up_proj": dense(f, d),
                "down_proj": dense(d, f),
            },
            "input_layernorm": ones(),
            "post_attention_layernorm": ones(),
        })
    return {"layers": layers, "norm": ones()}


def fuse_layer_weights(params: Params) -> None:
    """Concatenate q,k,v -> qkv_proj and gate,up -> gateup_proj in place
    (along the output axis), for raw ({"weight"}), W8A8 and affine dicts
    alike (packed 4-bit codes keep one output row per row too). Dicts with
    other keys (bias, adapters) stay unfused."""

    def fuse(dicts):
        keys = set(dicts[0].keys())
        if any(set(d.keys()) != keys for d in dicts):
            return None
        if not keys <= {"weight", "weight_q", "scales", "biases"}:
            return None
        return {k: torch.cat([d[k] for d in dicts], dim=0) for k in keys}

    for layer in params.get("layers", []):
        attn = layer["self_attn"]
        if "q_proj" in attn and "qkv_proj" not in attn:
            fused = fuse([attn["q_proj"], attn["k_proj"], attn["v_proj"]])
            if fused is not None:
                attn["qkv_proj"] = fused
                for k in ("q_proj", "k_proj", "v_proj"):
                    del attn[k]
        mlp = layer["mlp"]
        if "gate_proj" in mlp and "gateup_proj" not in mlp:
            fused = fuse([mlp["gate_proj"], mlp["up_proj"]])
            if fused is not None:
                mlp["gateup_proj"] = fused
                for k in ("gate_proj", "up_proj"):
                    del mlp[k]


def _attn_layer(
    p: Params,
    cfg: LlamaConfig,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
    mask_bias: Optional[torch.Tensor],
    cache: Optional[KVCache],
    layer_idx: int,
    flash_pad_len: Optional[torch.Tensor] = None,
    flash_train: bool = False,
    decode_pad_len: Optional[torch.Tensor] = None,
    flash_decode_min_b: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    lay = tensor_parallel.attn_layout(cfg)
    if lay is not None:
        # this rank's heads (ops/tensor_parallel.py); o_proj in-sharded
        parts = ((h * hd, (lay.q_lo * hd, lay.heads * hd)),
                 (hkv * hd, (lay.kv_lo * hd, lay.kv_heads * hd)),
                 (hkv * hd, (lay.kv_lo * hd, lay.kv_heads * hd)))
        if "qkv_proj" in p:
            q, k, v = tensor_parallel.split_out(
                p["qkv_proj"], linear(p["qkv_proj"], x, "out"), parts)
        else:
            q, k, v = (tensor_parallel.split_out(
                p[name], linear(p[name], x, "out"), (part,))[0]
                for name, part in zip(("q_proj", "k_proj", "v_proj"), parts))
        h, hkv = lay.heads, lay.kv_heads
        q, k, v = (q.reshape(b, s, h, hd), k.reshape(b, s, hkv, hd),
                   v.reshape(b, s, hkv, hd))
    elif "qkv_proj" in p:
        attn_dim, kv_dim = cfg.attn_dim, hkv * hd
        qkv = linear(p["qkv_proj"], x)
        q = qkv[..., :attn_dim].reshape(b, s, h, hd)
        k = qkv[..., attn_dim:attn_dim + kv_dim].reshape(b, s, hkv, hd)
        v = qkv[..., attn_dim + kv_dim:].reshape(b, s, hkv, hd)
    else:
        q = linear(p["q_proj"], x).reshape(b, s, h, hd)
        k = linear(p["k_proj"], x).reshape(b, s, hkv, hd)
        v = linear(p["v_proj"], x).reshape(b, s, hkv, hd)

    q = apply_rope(q, cos, sin, positions).transpose(1, 2)
    k = apply_rope(k, cos, sin, positions).transpose(1, 2)
    v = v.transpose(1, 2)

    if cache is not None:
        cache, k, v = cache.update_layer(layer_idx, k, v)

    if flash_pad_len is not None:
        # Kernel 2 over the first S cache slots (everything past the prompt
        # is causally unreachable); the k/v slices are read in place.
        out = flash_prefill_sdpa(q, k[:, :, :s], v[:, :, :s],
                                 scale=hd ** -0.5, pad_len=flash_pad_len)
    elif flash_train:
        # Kernels 6 and 7: differentiable causal attention of a fresh
        # sequence (no cache, pure causal mask: checked by llama_forward).
        out = flash_attention(q, k, v, scale=hd ** -0.5)
    elif (decode_pad_len is not None and flash_decode_min_b is not None
          and s == 1 and cache is not None and b >= flash_decode_min_b):
        # Kernel 4: one query position over the whole cache, keys valid at
        # pad <= pos <= cache.index (the slot just written; the cache
        # advances after the last layer), the mask computed in the kernel,
        # which reads the index tensor from device memory.
        out = flash_decode_sdpa(q, k, v, hd ** -0.5, decode_pad_len,
                                cache.index)
    else:
        out = sdpa(q, k, v, scale=hd ** -0.5, mask_bias=mask_bias)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return linear(p["o_proj"], out, "in" if lay is not None else None), \
        cache


def _layer(lp: Params, cfg: LlamaConfig, x: torch.Tensor, cos, sin,
           positions, mask_bias, cache: Optional[KVCache], idx: int,
           **attn) -> Tuple[torch.Tensor, Optional[KVCache]]:
    attn_out, cache = _attn_layer(
        lp["self_attn"], cfg, rms_norm(lp["input_layernorm"], x,
                                       cfg.rms_norm_eps),
        cos, sin, positions, mask_bias, cache, idx, **attn)
    x = x + attn_out
    h = rms_norm(lp["post_attention_layernorm"], x, cfg.rms_norm_eps)
    return x + swiglu_mlp(lp["mlp"], h, cfg.intermediate_size), cache


def llama_layer(lp: Params, cfg: LlamaConfig, x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor,
                mask_bias: Optional[torch.Tensor] = None,
                flash_train: bool = False,
                remat: bool = False) -> torch.Tensor:
    """One transformer layer of the training path (full sequence, no KV
    cache), as `llama_forward` and `parallel.pipeline_forward` run it.
    remat: the layer runs under `torch.utils.checkpoint` and is recomputed
    in the backward pass with the LoRA dropout masks of its first run."""
    if not remat:
        return _layer(lp, cfg, x, cos, sin, positions, mask_bias, None, 0,
                      flash_train=flash_train)[0]
    snapshot = layers.dropout_snapshot()

    def replayed(x):
        with layers.dropout_replay(snapshot):
            return _layer(lp, cfg, x, cos, sin, positions, mask_bias, None,
                          0, flash_train=flash_train)[0]

    return torch.utils.checkpoint.checkpoint(replayed, x, use_reentrant=False)


def llama_forward(
    params: Params,
    cfg: LlamaConfig,
    embeds: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
    mask_bias: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    flash_pad_len: Optional[torch.Tensor] = None,
    flash_train: bool = False,
    remat: bool = False,
    decode_pad_len: Optional[torch.Tensor] = None,
    flash_decode_min_b: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the stack.

    embeds: (B, S, D); positions: (B, S) or (S,) RoPE positions;
    mask_bias: additive fp32 bias broadcastable to (B, 1, S, S_k);
    cache: optional KVCache, written at cache.index and advanced by S (in
    place); flash_pad_len: (B,) left pads — attention then runs the
    flash-prefill kernel (causal + left-pad masks in the kernel) instead of
    the masked `sdpa`; it needs a fresh cache (prefill);
    flash_train: attention runs the differentiable flash kernels
    (`ops.flash_train.flash_attention`) — training only: no cache, and
    mask_bias None (the kernels mask causally themselves);
    remat: each layer runs under `torch.utils.checkpoint` and is recomputed
    in the backward pass (LoRA dropout masks replayed);
    decode_pad_len: (B,) left pads of a single-position decode step (the
    caller still passes the equivalent mask_bias); with
    `flash_decode_min_b` set and B >= it, attention runs the flash-decode
    kernel (`ops.attention.flash_decode_sdpa`) instead of the masked
    `sdpa`. `flash_decode_min_b` None (the default) keeps it off, as the
    JAX package's `CSM_TPU_FLASH_DECODE` does by default.

    Returns (hidden (B, S, D), cache).
    """
    if flash_pad_len is not None and (cache is None or cache.length != 0):
        raise ValueError("flash_pad_len needs a fresh KV cache (prefill)")
    if flash_train and (cache is not None or mask_bias is not None):
        raise ValueError(
            "flash_train requires a fresh causal sequence: no cache, and "
            "mask_bias must be None (the kernel applies causal masking "
            "itself; any other mask would be silently ignored)")

    x = embeds
    for idx, lp in enumerate(params["layers"]):
        if cache is None:
            x = llama_layer(lp, cfg, x, cos, sin, positions, mask_bias,
                            flash_train=flash_train, remat=remat)
        else:
            x, cache = _layer(lp, cfg, x, cos, sin, positions, mask_bias,
                              cache, idx, flash_pad_len=flash_pad_len,
                              decode_pad_len=decode_pad_len,
                              flash_decode_min_b=flash_decode_min_b)
    if cache is not None:
        cache = cache.advance(embeds.shape[1])
    return rms_norm(params["norm"], x, cfg.rms_norm_eps), cache

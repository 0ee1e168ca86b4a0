"""Primitive layers as plain functions over parameter dicts (port of
`csm_mlx_tpu/ops/layers.py`).

Parameters keep the checkpoint layout: Linear weights are (out, in),
embeddings (vocab, dim). `linear` dispatches on the dict itself: one that
carries `weight_q` runs the quantized path (`ops.quant.quant_linear`).
Norms accumulate in fp32 and cast back. LoRA / DoRA are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T (+ b), W stored (out, in)."""
    if "weight_q" in params:
        from csm_mlx_tpu_torch.ops.quant import quant_linear

        return quant_linear(params, x)
    y = torch.matmul(x, params["weight"].to(x.dtype).t())
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def emb_table(params: Params) -> torch.Tensor:
    """The embedding table stored (vocab, dim)."""
    return params["weight"]


def rms_norm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """weight * x / rms(x), rms taken in fp32."""
    xf = x.float()
    rrms = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * rrms).to(x.dtype) * params["weight"].to(x.dtype)


def swiglu_mlp(params: Dict[str, Params], x: torch.Tensor) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)); fused `gateup_proj` runs gate and up as
    one wide matmul (see models.llama.fuse_layer_weights)."""
    if "gateup_proj" in params:
        gu = linear(params["gateup_proj"], x)
        f = gu.shape[-1] // 2
        gate, up = gu[..., :f], gu[..., f:]
    else:
        gate = linear(params["gate_proj"], x)
        up = linear(params["up_proj"], x)
    return linear(params["down_proj"], F.silu(gate) * up)

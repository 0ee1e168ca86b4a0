"""Causal 1-D convolutions for the Mimi / SEANet codec (port of the batch
half of `csm_mlx_tpu/models/mimi/conv.py`).

Channel-first (B, C, T) arrays and the torch weight layouts: conv
(C_out, C_in/groups, K), transposed conv (C_in, C_out/groups, K). A causal
conv pads `(K-1)*dilation - (stride-1)` zeros on the left; a causal
transposed conv keeps the first T*stride outputs. The streaming states and
the int8 codec convs are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _bias(params: Params, x: torch.Tensor):
    b = params.get("bias")
    return None if b is None else b.to(x.dtype)


def conv1d(params: Params, x: torch.Tensor, *, stride: int = 1,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """'Valid' conv. x: (B, C_in, T); weight (C_out, C_in/groups, K)."""
    return F.conv1d(x, params["weight"].to(x.dtype), _bias(params, x),
                    stride=stride, dilation=dilation, groups=groups)


def causal_pad_amount(kernel: int, stride: int, dilation: int) -> int:
    return (kernel - 1) * dilation - (stride - 1)


def causal_conv1d(params: Params, x: torch.Tensor, *, stride: int = 1,
                  dilation: int = 1, groups: int = 1) -> torch.Tensor:
    pad = causal_pad_amount(params["weight"].shape[-1], stride, dilation)
    return conv1d(params, F.pad(x, (pad, 0)), stride=stride,
                  dilation=dilation, groups=groups)


def conv_transpose1d(params: Params, x: torch.Tensor, *, stride: int = 1,
                     groups: int = 1) -> torch.Tensor:
    """Full transposed conv: (B, C_in, T) -> (B, C_out, (T-1)*stride + K)."""
    return F.conv_transpose1d(x, params["weight"].to(x.dtype),
                              _bias(params, x), stride=stride, groups=groups)


def causal_conv_transpose1d(params: Params, x: torch.Tensor, *,
                            stride: int = 1, groups: int = 1) -> torch.Tensor:
    """Causal transposed conv: exactly T*stride samples (trim right)."""
    full = conv_transpose1d(params, x, stride=stride, groups=groups)
    return full[:, :, :x.shape[-1] * stride]

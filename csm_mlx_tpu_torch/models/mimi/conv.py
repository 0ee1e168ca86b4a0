"""Causal 1-D convolutions for the Mimi / SEANet codec (port of
`csm_mlx_tpu/models/mimi/conv.py`).

Channel-first (B, C, T) arrays and the torch weight layouts: conv
(C_out, C_in/groups, K), transposed conv (C_in, C_out/groups, K). A causal
conv pads `(K-1)*dilation - (stride-1)` zeros on the left; a causal
transposed conv keeps the first T*stride outputs.

The streaming forms carry state between chunks: a conv its last `pad`
input samples (`ConvState`), a transposed conv the overlap tail of its
last chunk (`ConvTrState`). Unlike the JAX states, which each call returns
anew, the port's are UPDATED IN PLACE, so that a step captured in a CUDA
graph keeps their buffers at fixed addresses; the calls still return the
state. The int8 codec convs are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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


# ---------------------------------------------------------------------------
# Streaming (state updated in place)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConvState:
    """Carried left context of a causal conv: prev (B, C_in, pad)."""

    prev: torch.Tensor


def make_conv_state(c_in: int, kernel: int, stride: int, dilation: int,
                    batch: int, dtype=torch.float32,
                    device: torch.device | str = "cpu") -> ConvState:
    pad = causal_pad_amount(kernel, stride, dilation)
    return ConvState(prev=torch.zeros((batch, c_in, max(pad, 0)),
                                      dtype=dtype, device=device))


def causal_conv1d_streaming(params: Params, x: torch.Tensor,
                            state: ConvState, *, stride: int = 1,
                            dilation: int = 1, groups: int = 1
                            ) -> Tuple[torch.Tensor, ConvState]:
    """Streamed causal conv over a chunk whose length is a multiple of
    stride: equal to the batch causal conv at the same offsets. state.prev
    (zeros at t = 0) becomes the chunk's last `pad` input samples."""
    if stride > 1 and x.shape[-1] % stride != 0:
        # a partial stride window would shift every later output
        raise ValueError(
            f"streamed conv chunk length {x.shape[-1]} must be a multiple "
            f"of stride {stride}")
    pad = causal_pad_amount(params["weight"].shape[-1], stride, dilation)
    if pad <= 0:
        return conv1d(params, x, stride=stride, dilation=dilation,
                      groups=groups), state
    buf = torch.cat([state.prev.to(x.dtype), x], dim=-1)
    out = conv1d(params, buf, stride=stride, dilation=dilation, groups=groups)
    state.prev.copy_(buf[:, :, buf.shape[-1] - pad:])
    return out, state


@dataclasses.dataclass
class ConvTrState:
    """Carried overlap tail of a causal transposed conv: partial (B, C_out,
    K - stride)."""

    partial: torch.Tensor


def make_convtr_state(c_out: int, kernel: int, stride: int, batch: int,
                      dtype=torch.float32,
                      device: torch.device | str = "cpu") -> ConvTrState:
    return ConvTrState(partial=torch.zeros(
        (batch, c_out, max(kernel - stride, 0)), dtype=dtype, device=device))


def causal_conv_transpose1d_streaming(params: Params, x: torch.Tensor,
                                      state: ConvTrState, *, stride: int = 1,
                                      groups: int = 1
                                      ) -> Tuple[torch.Tensor, ConvTrState]:
    """Streamed causal transposed conv emitting T*stride samples a call.

    The full transposed conv of a chunk makes (T-1)*stride + K samples: its
    first K - stride overlap the previous chunk's carried tail (added in),
    its last K - stride are carried. The bias is added once per emitted
    sample; the carried tail keeps only the linear part."""
    k = params["weight"].shape[-1]
    tail = k - stride
    full = conv_transpose1d({"weight": params["weight"]}, x, stride=stride,
                            groups=groups)  # (B, C_out, (T-1)*stride + K)
    t_out = x.shape[-1] * stride
    if tail > t_out:
        # the tail would overlap both the output and the carry
        raise ValueError(
            f"streamed conv-transpose needs K-stride ({tail}) <= "
            f"T*stride ({t_out}); feed larger chunks or use K <= 2*stride")
    if tail > 0:
        head = full[:, :, :tail] + state.partial.to(full.dtype)
        emitted = torch.cat([head, full[:, :, tail:t_out]], dim=-1)
        state.partial.copy_(full[:, :, t_out:])
    else:
        emitted = full[:, :, :t_out]
    bias = params.get("bias")
    if bias is not None:
        emitted = emitted + bias.to(emitted.dtype)[None, :, None]
    return emitted, state

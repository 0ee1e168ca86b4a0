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
state.

A conv whose params carry `weight_q` (int8 codes, symmetric per output
channel, from `models/mimi/quant.py`) runs the int8 arithmetic: the
activations quantized per batch row over the whole (C, T) chunk
(`_quant_act`), int8 x int8 sums in int32, then out = s_o * absmax/127 *
sums + bias in fp32. On the card the sums are one int8 GEMM
(`torch._int_mm`, cuBLASLt on the tensor cores): a conv over its unfolded
windows, a transposed conv as the product of the input with every tap
followed by an overlap-add of the int32 products, operands zero-padded to
the GEMM's shape rules. On the CPU they are the plain version, a float64
conv of the codes (exact: every partial sum stays far below 2**53). The
JAX package runs the same sums through XLA's int8 conv.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from csm_mlx_tpu_torch.ops import launches

Params = Dict[str, torch.Tensor]


def _bias(params: Params, x: torch.Tensor):
    b = params.get("bias")
    return None if b is None else b.to(x.dtype)


def _weight(params: Params) -> torch.Tensor:
    """The conv's weight or, quantized, its codes (for their shape)."""
    return params["weight_q"] if "weight_q" in params else params["weight"]


def _quant_act(x: torch.Tensor):
    """Per-batch-row dynamic int8 activation codes: one scale over the
    whole (C, T) chunk, since the conv's reduction spans channels and taps
    and every element it sums must share a scale. -> (int8 codes, fp32
    absmax / 127 of shape (B, 1, 1))."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=(1, 2), keepdim=True), min=1e-6)
    # a true division, as JAX's 127.0 / amax
    xq = torch.clamp(torch.round(xf * (torch.full_like(amax, 127.0) / amax)),
                     -127, 127).to(torch.int8)
    return xq, amax * (1.0 / 127.0)


def _int_mm_padded(a: torch.Tensor, w: torch.Tensor,
                   int_mm=None) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8 ^T -> (M, N) int32 through one
    `torch._int_mm` (or `int_mm`): zero rows and columns pad M past 16 and
    K and N to multiples of 8, its shape rules; the weight goes in as the
    transpose of a row-major (N, K) matrix."""
    m, k = a.shape
    n = w.shape[0]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w = F.pad(w, (0, pk, 0, pn))
    out = (int_mm or torch._int_mm)(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if pm or pn else out


def int8_conv1d_sums_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                           dilation: int) -> torch.Tensor:
    """Plain version of `int8_conv1d_sums`: a float64 conv of the codes,
    exact, as int32."""
    return F.conv1d(xq.double(), wq.double(), stride=stride,
                    dilation=dilation).to(torch.int32)


def _conv1d_gemm(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                 dilation: int, mm=_int_mm_padded) -> torch.Tensor:
    """The conv's sums as one GEMM `mm` over the unfolded windows,
    (B * T_out, C_in * K) x (C_in * K, C_out)."""
    b, c_in, _ = xq.shape
    c_out, _, k = wq.shape
    span = (k - 1) * dilation + 1
    win = xq.unfold(2, span, stride)[..., ::dilation]  # (B, C_in, T_out, K)
    t_out = win.shape[2]
    a = win.permute(0, 2, 1, 3).reshape(b * t_out, c_in * k)
    sums = mm(a, wq.reshape(c_out, c_in * k))
    return sums.reshape(b, t_out, c_out).transpose(1, 2)


def int8_conv1d_sums(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                     dilation: int = 1) -> torch.Tensor:
    """The int32 sums of a 'valid' conv of int8 codes: xq (B, C_in, T),
    wq (C_out, C_in, K) -> (B, C_out, T_out). On the card one int8 GEMM
    (`_conv1d_gemm`); on the CPU the plain version."""
    if xq.device.type == "cpu":
        return int8_conv1d_sums_plain(xq, wq, stride, dilation)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv1d_sums: unsupported device {xq.device}")
    sums = _conv1d_gemm(xq, wq, stride, dilation)
    int8_conv1d_sums.launches += 1
    return sums


def int8_conv_transpose1d_sums_plain(xq: torch.Tensor, wq: torch.Tensor,
                                     stride: int) -> torch.Tensor:
    """Plain version of `int8_conv_transpose1d_sums`: a float64 transposed
    conv of the codes, exact, as int32."""
    return F.conv_transpose1d(xq.double(), wq.double(),
                              stride=stride).to(torch.int32)


def _conv_transpose1d_gemm(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                           mm=_int_mm_padded) -> torch.Tensor:
    """The transposed conv's sums as one GEMM `mm` of every input sample
    with every (C_out, tap) column, (B * T, C_in) x (C_in, C_out * K), then
    the taps of sample t added in at t * stride (int32, exact)."""
    b, c_in, t = xq.shape
    _, c_out, k = wq.shape
    a = xq.transpose(1, 2).reshape(b * t, c_in)
    w = wq.permute(1, 2, 0).reshape(c_out * k, c_in)
    prod = mm(a, w).reshape(b, t, c_out, k)
    # the taps in groups of `stride`: group g of sample t lands on
    # [(t + g) * stride, (t + g + 1) * stride)
    groups = -(-k // stride)
    out = torch.zeros((b, c_out, (t + groups - 1) * stride),
                      dtype=torch.int32, device=xq.device)
    for g in range(groups):
        taps = prod[..., g * stride:(g + 1) * stride]  # (B, T, C_out, w)
        view = out[:, :, g * stride:(g + t) * stride].unflatten(2, (t, stride))
        view[..., :taps.shape[-1]] += taps.permute(0, 2, 1, 3)
    return out[:, :, :(t - 1) * stride + k]


def int8_conv_transpose1d_sums(xq: torch.Tensor, wq: torch.Tensor,
                               stride: int = 1) -> torch.Tensor:
    """The int32 sums of a full transposed conv of int8 codes: xq (B, C_in,
    T), wq (C_in, C_out, K) -> (B, C_out, (T - 1) * stride + K). On the card
    one int8 GEMM and an overlap-add (`_conv_transpose1d_gemm`); on the CPU
    the plain version."""
    if xq.device.type == "cpu":
        return int8_conv_transpose1d_sums_plain(xq, wq, stride)
    if xq.device.type != "cuda":
        raise ValueError(
            f"int8_conv_transpose1d_sums: unsupported device {xq.device}")
    sums = _conv_transpose1d_gemm(xq, wq, stride)
    int8_conv_transpose1d_sums.launches += 1
    return sums


launches.register(int8_conv1d_sums)
launches.register(int8_conv_transpose1d_sums)


def _int8_fixup(params: Params, sums: torch.Tensor, inv_xs: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-out-channel fix-up: s_o * absmax/127 * sums (+ bias)."""
    out = (sums.float() * params["scales"].float()[None, :, None] * inv_xs)
    if "bias" in params:
        out = out + params["bias"].float()[None, :, None]
    return out.to(x.dtype)


def conv1d(params: Params, x: torch.Tensor, *, stride: int = 1,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """'Valid' conv. x: (B, C_in, T); weight (C_out, C_in/groups, K); a
    quantized dict ({"weight_q" (C_out, C_in, K) int8, "scales" (C_out,)})
    runs the int8 arithmetic."""
    if "weight_q" in params:
        if groups != 1:
            raise ValueError("quantized conv1d supports groups=1 only")
        xq, inv_xs = _quant_act(x)
        sums = int8_conv1d_sums(xq, params["weight_q"], stride, dilation)
        return _int8_fixup(params, sums, inv_xs, x)
    return F.conv1d(x, params["weight"].to(x.dtype), _bias(params, x),
                    stride=stride, dilation=dilation, groups=groups)


def causal_pad_amount(kernel: int, stride: int, dilation: int) -> int:
    return (kernel - 1) * dilation - (stride - 1)


def causal_conv1d(params: Params, x: torch.Tensor, *, stride: int = 1,
                  dilation: int = 1, groups: int = 1) -> torch.Tensor:
    pad = causal_pad_amount(_weight(params).shape[-1], stride, dilation)
    return conv1d(params, F.pad(x, (pad, 0)), stride=stride,
                  dilation=dilation, groups=groups)


def conv_transpose1d(params: Params, x: torch.Tensor, *, stride: int = 1,
                     groups: int = 1) -> torch.Tensor:
    """Full transposed conv: (B, C_in, T) -> (B, C_out, (T-1)*stride + K).
    A quantized dict (codes in the same (C_in, C_out, K) layout, scales per
    C_out) runs the int8 arithmetic."""
    if "weight_q" in params:
        if groups != 1:
            raise ValueError("quantized conv-transpose supports groups=1 "
                             "only")
        xq, inv_xs = _quant_act(x)
        sums = int8_conv_transpose1d_sums(xq, params["weight_q"], stride)
        return _int8_fixup(params, sums, inv_xs, x)
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
    pad = causal_pad_amount(_weight(params).shape[-1], stride, dilation)
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
    k = _weight(params).shape[-1]
    tail = k - stride
    # no bias yet (added once per emitted sample below); the codes pass
    # through, so a streamed step runs the int8 conv of the batch path
    p_nobias = {key: v for key, v in params.items() if key != "bias"}
    full = conv_transpose1d(p_nobias, x, stride=stride,
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

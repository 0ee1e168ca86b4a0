"""SEANet encoder and decoder (port of `csm_mlx_tpu/models/mimi/seanet.py`).

Init conv (k=7); then per stage residual blocks and a strided downsample
over the reversed ratios (encoder), or a causal transposed upsample and
residual blocks over the ratios (decoder); ELU activations, final conv
(k=3); all convs causal (a decoder conv may be int8, `models/mimi/quant.py`:
its codes set its shape). Parameters: {"init": conv, "stages":
[{"residual": [{"conv1", "conv2"}], "down" | "up"}], "final": conv}.
`seanet_encode` / `seanet_decode` run a whole sequence;
`seanet_encode_streaming` / `seanet_decode_streaming` a chunk, over the
list of conv states that `seanet_encoder_init_state` /
`seanet_decoder_init_state` make (updated in place).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from csm_mlx_tpu_torch.device import resolve_device
from csm_mlx_tpu_torch.models.mimi.config import MimiConfig
from csm_mlx_tpu_torch.models.mimi.conv import (
    _weight, causal_conv1d_streaming, causal_conv_transpose1d,
    causal_conv_transpose1d_streaming, conv1d, make_conv_state,
    make_convtr_state)

Params = Dict[str, Any]


def _enc_ratios(cfg: MimiConfig) -> Tuple[int, ...]:
    return tuple(reversed(cfg.upsampling_ratios))


def _dilation(cfg: MimiConfig, block_idx: int) -> int:
    return cfg.dilation_growth_rate ** block_idx


def _extra_right_pad(t: int, kernel: int, stride: int, dilation: int) -> int:
    """HF/Encodec extra right padding so a strided conv covers the input."""
    eff_k = (kernel - 1) * dilation + 1
    pad_total = eff_k - stride
    n_frames = math.ceil((t - eff_k + pad_total) / stride + 1) - 1
    ideal = n_frames * stride + eff_k - pad_total
    return max(ideal - t, 0)


def _causal_conv_batch(p: Params, x: torch.Tensor, stride: int,
                       dilation: int = 1, groups: int = 1,
                       pad_mode: str = "constant") -> torch.Tensor:
    """Causal conv of a whole sequence: eff_k - stride samples padded on
    the left (zeros, or with pad_mode="replicate" copies of the first
    sample), and HF's extra right padding."""
    k = _weight(p).shape[-1]
    eff_k = (k - 1) * dilation + 1
    left = eff_k - stride
    right = _extra_right_pad(x.shape[-1], k, stride, dilation)
    mode = "replicate" if pad_mode == "replicate" else "constant"
    return conv1d(p, F.pad(x, (left, right), mode=mode), stride=stride,
                  dilation=dilation, groups=groups)


def seanet_encode(params: Params, cfg: MimiConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """(B, 1, T) waveform -> (B, hidden, T / prod(ratios)) 25 Hz latent."""
    h = _causal_conv_batch(params["init"], x, 1)
    for stage, ratio in zip(params["stages"], _enc_ratios(cfg)):
        for j, block in enumerate(stage["residual"]):
            r = _causal_conv_batch(block["conv1"], F.elu(h), 1,
                                   dilation=_dilation(cfg, j))
            r = _causal_conv_batch(block["conv2"], F.elu(r), 1)
            h = h + r
        h = _causal_conv_batch(stage["down"], F.elu(h), ratio)
    return _causal_conv_batch(params["final"], F.elu(h), 1)


def seanet_decode(params: Params, cfg: MimiConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """(B, hidden, F25) latent -> (B, 1, F25 * prod(ratios)) waveform."""
    h = _causal_conv_batch(params["init"], x, 1)
    for stage, ratio in zip(params["stages"], cfg.upsampling_ratios):
        h = causal_conv_transpose1d(stage["up"], F.elu(h), stride=ratio)
        for j, block in enumerate(stage["residual"]):
            r = _causal_conv_batch(block["conv1"], F.elu(h), 1,
                                   dilation=_dilation(cfg, j))
            r = _causal_conv_batch(block["conv2"], F.elu(r), 1)
            h = h + r
    return _causal_conv_batch(params["final"], F.elu(h), 1)


def seanet_decoder_init_state(params: Params, cfg: MimiConfig, batch: int,
                              dtype=torch.float32,
                              device: torch.device | str | None = None
                              ) -> List[Any]:
    """Zero states, in the order `seanet_decode_streaming` takes them (on
    the params' device unless `device` says otherwise)."""
    device = resolve_device(device, params)
    states: List[Any] = []

    def conv_state(p, dilation=1):
        _, c_in, k = _weight(p).shape
        states.append(make_conv_state(c_in, k, 1, dilation, batch, dtype,
                                      device))

    def convtr_state(p, stride):
        _, c_out, k = _weight(p).shape
        states.append(make_convtr_state(c_out, k, stride, batch, dtype,
                                        device))

    conv_state(params["init"])
    for stage, ratio in zip(params["stages"], cfg.upsampling_ratios):
        convtr_state(stage["up"], ratio)
        for j, block in enumerate(stage["residual"]):
            conv_state(block["conv1"], dilation=_dilation(cfg, j))
            conv_state(block["conv2"])
    conv_state(params["final"])
    return states


def seanet_decode_streaming(params: Params, cfg: MimiConfig, x: torch.Tensor,
                            states: List[Any]
                            ) -> Tuple[torch.Tensor, List[Any]]:
    """A chunk x (B, hidden, F25) -> (B, 1, F25 * prod(ratios)); `states`
    updated in place and returned."""
    it = iter(states)

    def conv(p, h, dilation=1):
        return causal_conv1d_streaming(p, h, next(it), dilation=dilation)[0]

    h = conv(params["init"], x)
    for stage, ratio in zip(params["stages"], cfg.upsampling_ratios):
        h = causal_conv_transpose1d_streaming(stage["up"], F.elu(h), next(it),
                                              stride=ratio)[0]
        for j, block in enumerate(stage["residual"]):
            r = conv(block["conv1"], F.elu(h), dilation=_dilation(cfg, j))
            r = conv(block["conv2"], F.elu(r))
            h = h + r
    return conv(params["final"], F.elu(h)), states


def seanet_encoder_init_state(params: Params, cfg: MimiConfig, batch: int,
                              dtype=torch.float32,
                              device: torch.device | str | None = None
                              ) -> List[Any]:
    """Zero states, in the order `seanet_encode_streaming` takes them (on
    the params' device unless `device` says otherwise)."""
    device = resolve_device(device, params)
    states: List[Any] = []

    def conv_state(p, stride=1, dilation=1):
        _, c_in, k = _weight(p).shape
        states.append(make_conv_state(c_in, k, stride, dilation, batch, dtype,
                                      device))

    conv_state(params["init"])
    for stage, ratio in zip(params["stages"], _enc_ratios(cfg)):
        for j, block in enumerate(stage["residual"]):
            conv_state(block["conv1"], dilation=_dilation(cfg, j))
            conv_state(block["conv2"])
        conv_state(stage["down"], stride=ratio)
    conv_state(params["final"])
    return states


def seanet_encode_streaming(params: Params, cfg: MimiConfig, x: torch.Tensor,
                            states: List[Any]
                            ) -> Tuple[torch.Tensor, List[Any]]:
    """A chunk x (B, 1, T), T a multiple of prod(ratios) -> (B, hidden,
    T / prod(ratios)); `states` updated in place and returned."""
    it = iter(states)

    def conv(p, h, stride=1, dilation=1):
        return causal_conv1d_streaming(p, h, next(it), stride=stride,
                                       dilation=dilation)[0]

    h = conv(params["init"], x)
    for stage, ratio in zip(params["stages"], _enc_ratios(cfg)):
        for j, block in enumerate(stage["residual"]):
            r = conv(block["conv1"], F.elu(h), dilation=_dilation(cfg, j))
            r = conv(block["conv2"], F.elu(r))
            h = h + r
        h = conv(stage["down"], F.elu(h), stride=ratio)
    return conv(params["final"], F.elu(h)), states


def _conv_init(generator: torch.Generator, c_out: int, c_in: int, k: int,
               dtype, device) -> Params:
    w = torch.randn((c_out, c_in, k), generator=generator, device=device,
                    dtype=torch.float32)
    return {"weight": (w * (c_in * k) ** -0.5).to(dtype),
            "bias": torch.zeros((c_out,), dtype=dtype, device=device)}


def init_seanet_encoder_params(generator: torch.Generator, cfg: MimiConfig,
                               dtype=torch.float32,
                               device: torch.device | str | None = None
                               ) -> Params:
    device = resolve_device(device)
    n = cfg.num_filters
    params: Params = {"init": _conv_init(generator, n, cfg.audio_channels,
                                         cfg.kernel_size, dtype, device),
                      "stages": []}
    cur = n
    for ratio in _enc_ratios(cfg):
        hidden = cur // cfg.compress
        blocks = [{"conv1": _conv_init(generator, hidden, cur,
                                       cfg.residual_kernel_size, dtype,
                                       device),
                   "conv2": _conv_init(generator, cur, hidden, 1, dtype,
                                       device)}
                  for _ in range(cfg.num_residual_layers)]
        params["stages"].append({
            "residual": blocks,
            "down": _conv_init(generator, cur * 2, cur, ratio * 2, dtype,
                               device)})
        cur *= 2
    params["final"] = _conv_init(generator, cfg.hidden_size, cur,
                                 cfg.last_kernel_size, dtype, device)
    return params


def init_seanet_decoder_params(generator: torch.Generator, cfg: MimiConfig,
                               dtype=torch.float32,
                               device: torch.device | str | None = None
                               ) -> Params:
    device = resolve_device(device)

    def conv(c_out, c_in, k):
        return _conv_init(generator, c_out, c_in, k, dtype, device)

    cur = cfg.num_filters * 2 ** len(cfg.upsampling_ratios)
    params: Params = {"init": conv(cur, cfg.hidden_size, cfg.kernel_size),
                      "stages": []}
    for ratio in cfg.upsampling_ratios:
        k = ratio * 2
        w = torch.randn((cur, cur // 2, k), generator=generator,
                        device=device, dtype=torch.float32)
        hidden = (cur // 2) // cfg.compress
        blocks = [{"conv1": conv(hidden, cur // 2, cfg.residual_kernel_size),
                   "conv2": conv(cur // 2, hidden, 1)}
                  for _ in range(cfg.num_residual_layers)]
        params["stages"].append({
            "up": {"weight": (w * (cur * k) ** -0.5).to(dtype),
                   "bias": torch.zeros((cur // 2,), dtype=dtype,
                                       device=device)},
            "residual": blocks,
        })
        cur //= 2
    params["final"] = conv(cfg.audio_channels, cfg.num_filters,
                           cfg.last_kernel_size)
    return params

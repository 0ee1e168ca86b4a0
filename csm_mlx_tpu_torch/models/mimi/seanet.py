"""SEANet decoder, batch mode (port of `csm_mlx_tpu/models/mimi/seanet.py`).

Init conv (k=7), then per ratio a causal transposed upsample and residual
blocks, ELU activations, final conv (k=3); all convs causal. Parameters:
{"init": conv, "stages": [{"up", "residual": [{"conv1", "conv2"}]}],
"final": conv}. The encoder and the streaming decoder are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from csm_mlx_tpu_torch.models.mimi.config import MimiConfig
from csm_mlx_tpu_torch.models.mimi.conv import causal_conv_transpose1d, conv1d

Params = Dict[str, Any]


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
                       dilation: int = 1) -> torch.Tensor:
    k = p["weight"].shape[-1]
    eff_k = (k - 1) * dilation + 1
    left = eff_k - stride
    right = _extra_right_pad(x.shape[-1], k, stride, dilation)
    return conv1d(p, F.pad(x, (left, right)), stride=stride, dilation=dilation)


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


def init_seanet_decoder_params(generator: torch.Generator, cfg: MimiConfig,
                               dtype=torch.float32,
                               device: torch.device | str = "cpu") -> Params:
    def conv(c_out, c_in, k):
        w = torch.randn((c_out, c_in, k), generator=generator, device=device,
                        dtype=torch.float32)
        return {"weight": (w * (c_in * k) ** -0.5).to(dtype),
                "bias": torch.zeros((c_out,), dtype=dtype, device=device)}

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

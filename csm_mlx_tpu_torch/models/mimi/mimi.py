"""Mimi codec, decode direction (port of `csm_mlx_tpu/models/mimi/mimi.py`).

decode: (B, K, F) codes --RVQ sum--> 12.5 Hz latent --grouped causal
transposed conv (x2)--> 25 Hz --transformer--> --SEANet--> (B, 1, F * 1920)
waveform at 24 kHz.

The JAX package pads F to a bucket so that each bucket compiles once; every
stage is causal, so the first F frames do not depend on the padding, and
the eager port decodes the F frames as they are. Encode, the streaming
decode and checkpoint loading are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from csm_mlx_tpu_torch.device import resolve_device
from csm_mlx_tpu_torch.models.mimi.config import MimiConfig
from csm_mlx_tpu_torch.models.mimi.conv import causal_conv_transpose1d
from csm_mlx_tpu_torch.models.mimi.rvq import (init_split_rvq_params,
                                               split_rvq_decode)
from csm_mlx_tpu_torch.models.mimi.seanet import (init_seanet_decoder_params,
                                                  seanet_decode)
from csm_mlx_tpu_torch.models.mimi.transformer import (init_transformer_params,
                                                       transformer_forward)

Params = Dict[str, Any]


def mimi_decode_fn(params: Params, cfg: MimiConfig,
                   codes: torch.Tensor) -> torch.Tensor:
    """(B, K, F) -> (B, 1, T) waveform."""
    latent = split_rvq_decode(params["quantizer"], codes)  # (B, D, F)
    latent = causal_conv_transpose1d(params["upsample"], latent,
                                     stride=cfg.downsample_stride,
                                     groups=cfg.upsample_groups)
    h = transformer_forward(params["decoder_transformer"], cfg,
                            latent.transpose(1, 2))
    return seanet_decode(params["decoder"], cfg, h.transpose(1, 2))


def init_mimi_params(generator: torch.Generator, cfg: MimiConfig,
                     dtype=torch.float32,
                     device: torch.device | str | None = None) -> Params:
    """Random init of the decode-direction parameters (on `cuda` unless
    `device` says otherwise)."""
    device = resolve_device(device)
    d, s = cfg.hidden_size, cfg.downsample_stride
    up = torch.randn((d, d // cfg.upsample_groups, 2 * s), generator=generator,
                     device=device, dtype=torch.float32)
    return {
        "decoder": init_seanet_decoder_params(generator, cfg, dtype, device),
        "decoder_transformer": init_transformer_params(generator, cfg, dtype,
                                                       device),
        "quantizer": init_split_rvq_params(generator, cfg, dtype, device),
        "upsample": {"weight": (up * (2 * s) ** -0.5).to(dtype)},
    }


class Mimi:
    """The codec: `cfg`, `params`, `device`; `decode` maps codes to audio.
    The device is `device` if given, else that of `params`, else `cuda`."""

    def __init__(self, cfg: MimiConfig, params: Optional[Params] = None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device, params)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0)
            params = init_mimi_params(generator, cfg, dtype, self.device)
        self.params = params
        self.frame_size = cfg.frame_size

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, K, F) int codes -> (B, 1, F * frame_size) waveform."""
        codes = torch.as_tensor(codes, device=self.device).long()
        return mimi_decode_fn(self.params, self.cfg, codes)

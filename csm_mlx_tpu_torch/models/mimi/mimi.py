"""Mimi codec, decode direction (port of `csm_mlx_tpu/models/mimi/mimi.py`).

decode: (B, K, F) codes --RVQ sum--> 12.5 Hz latent --grouped causal
transposed conv (x2)--> 25 Hz --transformer--> --SEANet--> (B, 1, F * 1920)
waveform at 24 kHz.

The JAX package pads F to a bucket so that each bucket compiles once; every
stage is causal, so the first F frames do not depend on the padding, and
the eager port decodes the F frames as they are.

Streaming: `mimi_decode_step_fn` decodes the next F frames of a stream
over a `MimiDecodeState` (the ring KV cache of the transformer, the
upsample's and SEANet's conv states); the chunks of a stream, joined, are
its batch decode. The state is UPDATED IN PLACE (the JAX state is
returned anew), so that a step captured in a CUDA graph keeps its buffers
at fixed addresses. Encode and checkpoint loading are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from csm_mlx_tpu_torch.device import resolve_device
from csm_mlx_tpu_torch.models.mimi.config import MimiConfig
from csm_mlx_tpu_torch.models.mimi.conv import (
    ConvTrState, causal_conv_transpose1d, causal_conv_transpose1d_streaming,
    make_convtr_state)
from csm_mlx_tpu_torch.models.mimi.rvq import (init_split_rvq_params,
                                               split_rvq_decode)
from csm_mlx_tpu_torch.models.mimi.seanet import (init_seanet_decoder_params,
                                                  seanet_decode,
                                                  seanet_decode_streaming,
                                                  seanet_decoder_init_state)
from csm_mlx_tpu_torch.models.mimi.transformer import (RingKVCache,
                                                       init_transformer_params,
                                                       transformer_forward)

Params = Dict[str, Any]


@dataclasses.dataclass
class MimiDecodeState:
    transformer: RingKVCache
    upsample: ConvTrState
    seanet: List[Any]


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


def mimi_decode_step_fn(params: Params, cfg: MimiConfig, codes: torch.Tensor,
                        state: MimiDecodeState
                        ) -> Tuple[torch.Tensor, MimiDecodeState]:
    """The next F frames of a stream: (B, K, F) -> (B, 1, F * frame_size),
    `state` updated in place and returned. F is bounded by the ring's slack
    (`Mimi.init_decode_state`'s chunk_frames)."""
    latent = split_rvq_decode(params["quantizer"], codes)  # (B, D, F)
    latent, _ = causal_conv_transpose1d_streaming(
        params["upsample"], latent, state.upsample,
        stride=cfg.downsample_stride, groups=cfg.upsample_groups)
    h = transformer_forward(params["decoder_transformer"], cfg,
                            latent.transpose(1, 2), cache=state.transformer)
    audio, _ = seanet_decode_streaming(params["decoder"], cfg,
                                       h.transpose(1, 2), state.seanet)
    return audio, state


def reset_decode_row(state: MimiDecodeState, row) -> MimiDecodeState:
    """Recycle one batch row of a streaming decode state for a new stream,
    in place: its conv carries return to zeros; the ring keeps the shared
    index but sets the row's start there (and zeroes its keys), so the
    window mask hides the predecessor's keys and the row decodes as a fresh
    stream (up to the rotary phase's rounding)."""
    tr = state.transformer
    tr.start[row] = tr.index
    tr.k[:, row] = 0
    tr.v[:, row] = 0
    state.upsample.partial[row] = 0
    for st in state.seanet:
        (st.prev if hasattr(st, "prev") else st.partial)[row] = 0
    return state


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
        self._stream_decode_state: Optional[MimiDecodeState] = None

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, K, F) int codes -> (B, 1, F * frame_size) waveform."""
        codes = torch.as_tensor(codes, device=self.device).long()
        return mimi_decode_fn(self.params, self.cfg, codes)

    # -- streaming ------------------------------------------------------
    def init_decode_state(self, batch: int = 1,
                          chunk_frames: int = 1) -> MimiDecodeState:
        """A fresh stream's state. `chunk_frames`: the most frames one
        `decode_step` will take (each is `downsample_stride` transformer
        tokens); it sizes the ring's slack."""
        cfg = self.cfg
        slack = max(8, cfg.downsample_stride * chunk_frames)
        return MimiDecodeState(
            transformer=RingKVCache.init(cfg, batch, dtype=self.dtype,
                                         slack=slack, device=self.device),
            upsample=make_convtr_state(
                cfg.hidden_size, 2 * cfg.downsample_stride,
                cfg.downsample_stride, batch, self.dtype, self.device),
            seanet=seanet_decoder_init_state(self.params["decoder"], cfg,
                                             batch, self.dtype, self.device))

    @torch.no_grad()
    def decode_step(self, codes, state: Optional[MimiDecodeState] = None):
        """(B, K, F) codes -> ((B, 1, F * frame_size) audio, state).

        With `state=None`, an internal stream state is used and advanced —
        the reference's stateful interface; `reset_state()` between
        utterances. A given state is advanced in place (the JAX package
        returns a new one and leaves the given one as it was)."""
        codes = torch.as_tensor(codes, device=self.device).long()
        stateful = state is None
        if stateful:
            if self._stream_decode_state is None:
                self._stream_decode_state = self.init_decode_state(
                    batch=codes.shape[0])
            state = self._stream_decode_state
        audio, state = mimi_decode_step_fn(self.params, self.cfg, codes,
                                           state)
        return audio if stateful else (audio, state)

    def reset_state(self) -> None:
        """Drop the internal streaming state (the reference's
        Mimi.reset_state)."""
        self._stream_decode_state = None

"""Mimi codec (port of `csm_mlx_tpu/models/mimi/mimi.py`).

encode: (B, 1, T) waveform at 24 kHz --SEANet--> 25 Hz latent
--transformer--> --causal conv (/2, replicate-padded)--> 12.5 Hz
--split RVQ--> (B, K, F) codes.
decode: (B, K, F) codes --RVQ sum--> 12.5 Hz latent --grouped causal
transposed conv (x2)--> 25 Hz --transformer--> --SEANet--> (B, 1, F * 1920)
waveform.

Encode pads the waveform to whole frames of a bucket (`FRAME_BUCKETS`), as
the JAX package does, and keeps the first F frames; every stage is causal,
so they do not depend on the padding. Decode takes the F frames as they
are, unless the decoder is int8 (`models/mimi/quant.py`): its activation
scales span the whole chunk, so it pads to the bucket as JAX does.

Streaming: `mimi_encode_step_fn` encodes the next frame of a stream over a
`MimiEncodeState`, `mimi_decode_step_fn` decodes the next F frames over a
`MimiDecodeState` (the ring KV cache of the transformer, the conv
states); a stream's steps, joined, are its batch encode or decode. The
states are UPDATED IN PLACE (the JAX states are returned anew), so that a
step captured in a CUDA graph keeps its buffers at fixed addresses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from csm_mlx_tpu_torch.device import resolve_device
from csm_mlx_tpu_torch.models.mimi.config import MimiConfig
from csm_mlx_tpu_torch.models.mimi.quant import mimi_decoder_is_quantized
from csm_mlx_tpu_torch.models.mimi.conv import (
    ConvState, ConvTrState, causal_conv1d_streaming, causal_conv_transpose1d,
    causal_conv_transpose1d_streaming, make_conv_state, make_convtr_state)
from csm_mlx_tpu_torch.models.mimi.rvq import (init_split_rvq_params,
                                               split_rvq_decode,
                                               split_rvq_encode)
from csm_mlx_tpu_torch.models.mimi.seanet import (
    _causal_conv_batch, init_seanet_decoder_params,
    init_seanet_encoder_params, seanet_decode, seanet_decode_streaming,
    seanet_decoder_init_state, seanet_encode, seanet_encode_streaming,
    seanet_encoder_init_state)
from csm_mlx_tpu_torch.models.mimi.transformer import (RingKVCache,
                                                       init_transformer_params,
                                                       transformer_forward)

Params = Dict[str, Any]
FRAME_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int) -> int:
    for b in FRAME_BUCKETS:
        if n <= b:
            return b
    return n


@dataclasses.dataclass
class MimiDecodeState:
    transformer: RingKVCache
    upsample: ConvTrState
    seanet: List[Any]


@dataclasses.dataclass
class MimiEncodeState:
    transformer: RingKVCache
    downsample: ConvState
    downsample_filled: torch.Tensor  # () bool: the replicate-pad bootstrap
    seanet: List[Any]


def mimi_encode_latent(params: Params, cfg: MimiConfig,
                       audio: torch.Tensor) -> torch.Tensor:
    """(B, 1, T) -> (B, D, F) 12.5 Hz latent, the RVQ's input."""
    latent = seanet_encode(params["encoder"], cfg, audio)  # (B, D, F25)
    h = transformer_forward(params["encoder_transformer"], cfg,
                            latent.transpose(1, 2))
    return _causal_conv_batch(params["downsample"], h.transpose(1, 2),
                              cfg.downsample_stride, pad_mode="replicate")


def mimi_encode_fn(params: Params, cfg: MimiConfig, audio: torch.Tensor,
                   num_quantizers: int) -> torch.Tensor:
    """(B, 1, T) -> (B, K, F) int64 codes."""
    return split_rvq_encode(params["quantizer"],
                            mimi_encode_latent(params, cfg, audio),
                            num_quantizers)


def mimi_encode_step_fn(params: Params, cfg: MimiConfig, audio: torch.Tensor,
                        state: MimiEncodeState, num_quantizers: int
                        ) -> Tuple[torch.Tensor, MimiEncodeState]:
    """The next frame of a stream: (B, 1, frame_size) -> (B, K, 1) codes,
    `state` updated in place and returned."""
    latent, _ = seanet_encode_streaming(params["encoder"], cfg, audio,
                                        state.seanet)  # (B, D, 2)
    h = transformer_forward(params["encoder_transformer"], cfg,
                            latent.transpose(1, 2), cache=state.transformer)
    latent = h.transpose(1, 2)
    # the streamed replicate-padded downsample: on the first frame the
    # carried context is the first sample, repeated
    prev = state.downsample.prev
    prev.copy_(torch.where(state.downsample_filled, prev,
                           latent[:, :, :1].to(prev.dtype).expand_as(prev)))
    state.downsample_filled.fill_(True)
    latent, _ = causal_conv1d_streaming(params["downsample"], latent,
                                        state.downsample,
                                        stride=cfg.downsample_stride)
    return split_rvq_encode(params["quantizer"], latent,
                            num_quantizers), state


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
    """Random init (on `cuda` unless `device` says otherwise). The
    encode-direction parameters are drawn after the decode-direction ones,
    so a generator gives the decoder it gave before the encoder was
    ported."""
    device = resolve_device(device)
    d, s = cfg.hidden_size, cfg.downsample_stride
    up = torch.randn((d, d // cfg.upsample_groups, 2 * s), generator=generator,
                     device=device, dtype=torch.float32)
    params = {
        "decoder": init_seanet_decoder_params(generator, cfg, dtype, device),
        "decoder_transformer": init_transformer_params(generator, cfg, dtype,
                                                       device),
        "quantizer": init_split_rvq_params(generator, cfg, dtype, device),
        "upsample": {"weight": (up * (2 * s) ** -0.5).to(dtype)},
    }
    params["encoder"] = init_seanet_encoder_params(generator, cfg, dtype,
                                                   device)
    params["encoder_transformer"] = init_transformer_params(generator, cfg,
                                                            dtype, device)
    down = torch.randn((d, d, 2 * s), generator=generator, device=device,
                       dtype=torch.float32)
    params["downsample"] = {"weight": (down * (d * 2 * s) ** -0.5).to(dtype)}
    return params


class Mimi:
    """The codec: `cfg`, `params`, `device`; `encode` maps audio to codes,
    `decode` codes to audio. The device is `device` if given, else that of
    `params`, else `cuda`."""

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
        self._stream_encode_state: Optional[MimiEncodeState] = None

    def _resolve_nq(self, num_quantizers: Optional[int]) -> int:
        nq = (self.cfg.num_quantizers if num_quantizers is None
              else num_quantizers)
        if not 1 <= nq <= self.cfg.num_quantizers:
            raise ValueError(
                f"num_quantizers={nq} out of range [1, "
                f"{self.cfg.num_quantizers}]")
        return nq

    @torch.no_grad()
    def encode(self, audio, num_quantizers: Optional[int] = None
               ) -> torch.Tensor:
        """(B, 1, T) waveform -> (B, K, ceil(T / frame_size)) int64 codes.
        The waveform is padded with zeros to whole frames of a bucket."""
        nq = self._resolve_nq(num_quantizers)
        audio = torch.as_tensor(audio, device=self.device).float()
        t = audio.shape[-1]
        frames = -(-t // self.frame_size)
        pad_t = _bucket(frames) * self.frame_size - t
        if pad_t:
            audio = F.pad(audio, (0, pad_t))
        codes = mimi_encode_fn(self.params, self.cfg, audio, nq)
        return codes[:, :, :frames]

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, K, F) int codes -> (B, 1, F * frame_size) waveform."""
        codes = torch.as_tensor(codes, device=self.device).long()
        f = codes.shape[-1]
        if mimi_decoder_is_quantized(self.params):
            # an int8 conv's activation scale spans the whole chunk, so the
            # zero frames that the JAX package pads every decode with (to
            # its bucket) enter it: pad as it does
            codes = F.pad(codes, (0, _bucket(f) - f))
        return mimi_decode_fn(self.params, self.cfg,
                              codes)[:, :, :f * self.frame_size]

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

    def init_encode_state(self, batch: int = 1) -> MimiEncodeState:
        cfg = self.cfg
        return MimiEncodeState(
            transformer=RingKVCache.init(cfg, batch, dtype=self.dtype,
                                         device=self.device),
            downsample=make_conv_state(
                cfg.hidden_size, 2 * cfg.downsample_stride,
                cfg.downsample_stride, 1, batch, self.dtype, self.device),
            downsample_filled=torch.zeros((), dtype=torch.bool,
                                          device=self.device),
            seanet=seanet_encoder_init_state(self.params["encoder"], cfg,
                                             batch, self.dtype, self.device))

    @torch.no_grad()
    def encode_step(self, audio, state: Optional[MimiEncodeState] = None,
                    num_quantizers: Optional[int] = None):
        """(B, 1, frame_size) audio -> ((B, K, 1) codes, state); with
        `state=None` the internal stream state, as in `decode_step`."""
        nq = self._resolve_nq(num_quantizers)
        audio = torch.as_tensor(audio, device=self.device).float()
        stateful = state is None
        if stateful:
            if self._stream_encode_state is None:
                self._stream_encode_state = self.init_encode_state(
                    batch=audio.shape[0])
            state = self._stream_encode_state
        codes, state = mimi_encode_step_fn(self.params, self.cfg, audio,
                                           state, nq)
        return codes if stateful else (codes, state)

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
        """Drop the internal streaming states (the reference's
        Mimi.reset_state)."""
        self._stream_decode_state = None
        self._stream_encode_state = None

    # -- weights --------------------------------------------------------
    def load_pytorch_weights(self, path: str) -> "Mimi":
        """Load a local Mimi checkpoint (HF or moshi naming) onto the
        codec's device (`weights.load_mimi_checkpoint`)."""
        from csm_mlx_tpu_torch.models.mimi.weights import load_mimi_checkpoint

        self.params = load_mimi_checkpoint(path, self.cfg, dtype=self.dtype,
                                           device=self.device)
        return self

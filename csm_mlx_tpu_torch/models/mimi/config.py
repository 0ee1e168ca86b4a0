"""Mimi neural audio codec configuration (copy of `csm_mlx_tpu/models/mimi/config.py`).

The published kyutai/mimi architecture (identical to the HF `MimiConfig`
defaults): 24 kHz audio, SEANet encoder/decoder over ratios [8,6,5,4]
(25 Hz latent), 8-layer codec transformers with layer-scale + sliding-window
250, a stride-2 down/upsample pair to 12.5 Hz, and a split RVQ (1 semantic +
N-1 acoustic codebooks, 2048 entries, dim 256).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    sampling_rate: int = 24_000
    audio_channels: int = 1
    hidden_size: int = 512
    num_filters: int = 64
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 6, 5, 4)
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    compress: int = 2
    trim_right_ratio: float = 1.0
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    upsample_groups: int = 512
    # codec transformer
    num_hidden_layers: int = 8
    intermediate_size: int = 2048
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: int = 64
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    sliding_window: int = 250
    layer_scale_initial_scale: float = 0.01
    max_position_embeddings: int = 8000
    frame_rate: float = 12.5

    @property
    def encodec_frame_rate(self) -> float:
        # 24000 / prod(ratios) = 25 Hz before the stride-2 downsample.
        hop = 1
        for r in self.upsampling_ratios:
            hop *= r
        return self.sampling_rate / hop

    @property
    def frame_size(self) -> int:
        """Audio samples per RVQ frame (1920 = 80 ms @ 24 kHz)."""
        return int(self.sampling_rate / self.frame_rate)

    @property
    def downsample_stride(self) -> int:
        return int(self.encodec_frame_rate / self.frame_rate)

    @property
    def num_acoustic_quantizers(self) -> int:
        return self.num_quantizers - self.num_semantic_quantizers


def mimi_202407(num_codebooks: int = 32) -> MimiConfig:
    """The CSM/Moshi codec configuration (tokenizers.py:15)."""
    return MimiConfig(num_quantizers=num_codebooks)

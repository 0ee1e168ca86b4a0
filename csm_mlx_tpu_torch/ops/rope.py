"""Llama-3.1 scaled rotary position embeddings (port of `csm_mlx_tpu/ops/rope.py`).

The rotation is pair-INTERLEAVED: x is viewed as (..., D/2, 2) pairs, real
parts x[..., 0::2] and imaginary parts x[..., 1::2] — not the half-split
convention of HF Llama (and of Mimi's codec transformer). Frequencies and
the rotation run in fp32 and the result is cast back.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from csm_mlx_tpu_torch.config import LlamaConfig, RopeScalingConfig


def llama3_scaled_freqs(
    head_dim: int,
    base: float,
    scaling: RopeScalingConfig | None,
) -> np.ndarray:
    """Inverse frequencies with the Llama-3.1 wavelength rule (fp32)."""
    freqs = 1.0 / (
        base ** (np.arange(0, head_dim, 2)[: head_dim // 2].astype(np.float32) / head_dim)
    )
    if scaling is None or scaling.rope_type != "llama3":
        return freqs.astype(np.float32)

    old_context_len = float(scaling.original_max_position_embeddings)
    low_freq_wavelen = old_context_len / scaling.low_freq_factor
    high_freq_wavelen = old_context_len / scaling.high_freq_factor

    wavelen = 2.0 * math.pi / freqs
    smooth = (old_context_len / wavelen - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor
    )
    blended = (1.0 - smooth) * freqs / scaling.factor + smooth * freqs
    scaled = np.where(
        wavelen < high_freq_wavelen,
        freqs,
        np.where(wavelen > low_freq_wavelen, freqs / scaling.factor, blended),
    )
    return scaled.astype(np.float32)


@functools.lru_cache(maxsize=16)
def rope_cache(
    head_dim: int,
    base: float,
    scaling: RopeScalingConfig | None,
    max_seq_len: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) host tables of shape (max_seq_len, head_dim // 2), fp32."""
    theta = llama3_scaled_freqs(head_dim, base, scaling)
    pos = np.arange(max_seq_len, dtype=np.float32)
    idx_theta = np.outer(pos, theta).astype(np.float32)
    return np.cos(idx_theta), np.sin(idx_theta)


def rope_cache_for(cfg: LlamaConfig, max_seq_len: int,
                   device: torch.device | str = "cpu"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    cos, sin = rope_cache(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                          max_seq_len)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Rotate q/k by position.

    x: (B, S, H, D); cos/sin: (max_seq, D/2) fp32; positions: (B, S) or (S,)
    integer absolute positions, clamped to >= 0 (left-pad slots may carry
    negative fillers; they are masked out of attention anyway).
    """
    if positions.dim() == 1:
        positions = positions[None, :]
    positions = positions.clamp(min=0).long()
    c = cos[positions][:, :, None, :]  # (B, S, 1, D/2)
    s = sin[positions][:, :, None, :]
    xf = x.float()
    x0 = xf[..., 0::2]
    x1 = xf[..., 1::2]
    out0 = x0 * c - x1 * s
    out1 = x1 * c + x0 * s
    out = torch.stack([out0, out1], dim=-1).reshape(x.shape)
    return out.to(x.dtype)

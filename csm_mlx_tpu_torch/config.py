"""Model configurations for the PyTorch port.

A copy of `csm_mlx_tpu/config.py:19-92` (the rope-scaling, Llama stack and
registry definitions), not an import: importing any `csm_mlx_tpu` module
first runs that package's `__init__.py`, which imports JAX, and the port
must run where JAX is not installed.

Configs are frozen dataclasses so they can key caches (`rope_cache`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RopeScalingConfig:
    """Llama-3.1 rope scaling parameters."""

    factor: float = 32.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    rope_type: str = "llama3"


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Architecture of one Llama transformer stack."""

    model_type: str = "llama"
    vocab_size: int = 128_256
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 8192
    hidden_size: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500_000.0
    rope_scaling: Optional[RopeScalingConfig] = RopeScalingConfig()
    attention_bias: bool = False
    mlp_bias: bool = False
    max_position_embeddings: int = 2048

    @property
    def n_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def attn_dim(self) -> int:
        return self.num_attention_heads * self.head_dim


BACKBONE_CONFIGURATION = {
    "1b": LlamaConfig(
        vocab_size=128_256,
        num_hidden_layers=16,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=64,
        intermediate_size=8192,
        hidden_size=2048,
        rms_norm_eps=1e-5,
        rope_theta=500_000.0,
        rope_scaling=RopeScalingConfig(),
    )
}

DECODER_CONFIGURATION = {
    "100m": LlamaConfig(
        vocab_size=128_256,
        num_hidden_layers=4,
        num_attention_heads=8,
        num_key_value_heads=2,
        head_dim=128,
        intermediate_size=8192,
        hidden_size=1024,
        rms_norm_eps=1e-5,
        rope_theta=500_000.0,
        rope_scaling=RopeScalingConfig(),
    )
}

# The published sources of the tokenizers (JAX `config.py:94-102`), for
# reference: the port reads both from local paths only
# (`tokenizers.get_text_tokenizer`, `tokenizers.get_audio_tokenizer`).
TOKENIZERS = {
    "audio": {
        "repo_id": "kyutai/moshiko-pytorch-bf16",
        "filename": "tokenizer-e351c8d8-checkpoint125.safetensors",
    },
    "text": {"repo_id": "unsloth/Llama-3.2-1B"},
}

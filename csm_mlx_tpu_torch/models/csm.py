"""CSM dual-transformer model (port of `csm_mlx_tpu/models/csm.py`).

- `text_embeddings` (n_text_vocab, D) and one fused `audio_embeddings`
  table of (n_audio_vocab * n_codebooks, D) rows indexed by
  `token + codebook * n_audio_vocab`;
- per-step input = masked sum of the 32 audio-slot embeddings and the
  text-slot embedding;
- `projection` backbone -> decoder width, `codebook0_head`, and the
  `audio_head` tensor (n_codebooks - 1, D_dec, n_audio_vocab).

`CSM` is a thin shell over the parameter dict; compute is in functions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from csm_mlx_tpu_torch.config import (
    BACKBONE_CONFIGURATION,
    DECODER_CONFIGURATION,
    LlamaConfig,
)
from csm_mlx_tpu_torch.models.llama import init_llama_params
from csm_mlx_tpu_torch.ops.layers import emb_table

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelArgs:
    backbone_name: str
    decoder_name: str
    n_text_vocab: int
    n_audio_vocab: int
    n_audio_codebooks: int

    @property
    def backbone_config(self) -> LlamaConfig:
        return BACKBONE_CONFIGURATION[self.backbone_name]

    @property
    def decoder_config(self) -> LlamaConfig:
        return DECODER_CONFIGURATION[self.decoder_name]

    @property
    def backbone_dim(self) -> int:
        cfg = self.backbone_config
        return cfg.num_attention_heads * cfg.head_dim

    @property
    def decoder_dim(self) -> int:
        cfg = self.decoder_config
        return cfg.num_attention_heads * cfg.head_dim


def csm_1b() -> ModelArgs:
    """The CSM-1B configuration."""
    return ModelArgs(backbone_name="1b", decoder_name="100m",
                     n_text_vocab=128_256, n_audio_vocab=2051,
                     n_audio_codebooks=32)


def init_csm_params(generator: torch.Generator, args: ModelArgs,
                    dtype=torch.float32,
                    device: torch.device | str = "cpu") -> Params:
    """Random-initialized CSM parameters drawn from `generator` on `device`
    (checkpoint layout). `audio_head` is zero, as in the JAX init: with a
    zero head every decoder codebook is 0, so callers that generate from
    random weights draw it themselves."""
    d_b, d_d = args.backbone_dim, args.decoder_dim
    scale = d_b ** -0.5

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    return {
        "backbone": init_llama_params(generator, args.backbone_config, dtype,
                                      device),
        "decoder": init_llama_params(generator, args.decoder_config, dtype,
                                     device),
        "text_embeddings": {"weight": normal(args.n_text_vocab, d_b)},
        "audio_embeddings": {
            "weight": normal(args.n_audio_vocab * args.n_audio_codebooks, d_b)},
        "projection": {"weight": normal(d_d, d_b)},
        "codebook0_head": {"weight": normal(args.n_audio_vocab, d_b)},
        "audio_head": torch.zeros(
            (args.n_audio_codebooks - 1, d_d, args.n_audio_vocab),
            dtype=dtype, device=device),
    }


def embed_audio(params: Params, args: ModelArgs, codebook: int,
                tokens: torch.Tensor) -> torch.Tensor:
    """Embedding of `tokens` under codebook number `codebook`."""
    return emb_table(params["audio_embeddings"])[
        tokens + codebook * args.n_audio_vocab]


def embed_tokens(params: Params, args: ModelArgs,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Per-slot embeddings of a (B, S, 33) frame tensor -> (B, S, 33, D):
    slots 0..31 audio, offset into the fused table; slot 32 text."""
    text = emb_table(params["text_embeddings"])[tokens[:, :, -1]][:, :, None, :]
    offsets = torch.arange(args.n_audio_codebooks, device=tokens.device,
                           dtype=tokens.dtype) * args.n_audio_vocab
    audio = emb_table(params["audio_embeddings"])[tokens[:, :, :-1] + offsets]
    return torch.cat([audio, text], dim=-2)


def masked_input_embeds(params: Params, args: ModelArgs, tokens: torch.Tensor,
                        token_mask: torch.Tensor) -> torch.Tensor:
    """Masked sum over the 33 slots -> backbone input (B, S, D)."""
    emb = embed_tokens(params, args, tokens)
    return (emb * token_mask[..., None].to(emb.dtype)).sum(dim=-2)


class CSM:
    """Model object: `args`, `params` (nested dict of tensors), `dtype`,
    `device`."""

    def __init__(
        self,
        args: ModelArgs,
        params: Optional[Params] = None,
        dtype=torch.bfloat16,
        generator: Optional[torch.Generator] = None,
        device: torch.device | str = "cpu",
    ):
        self.args = args
        self.n_audio_codebooks = args.n_audio_codebooks
        self.dtype = dtype
        self.device = torch.device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0)
            params = init_csm_params(generator, args, dtype, self.device)
        self.params = params

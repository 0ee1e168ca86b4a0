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
from csm_mlx_tpu_torch.device import resolve_device
from csm_mlx_tpu_torch.models.llama import init_llama_params
from csm_mlx_tpu_torch.ops import tensor_parallel
from csm_mlx_tpu_torch.ops.layers import linear

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
                    device: torch.device | str | None = None) -> Params:
    """Random-initialized CSM parameters drawn from `generator` on `device`
    (default `cuda`, see `device.resolve_device`), in checkpoint layout.
    `audio_head` is zero, as in the JAX init: with a zero head every decoder
    codebook is 0, so callers that generate from random weights draw it
    themselves."""
    device = resolve_device(device)
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
    """Embedding of `tokens` under codebook number `codebook` (a masked
    lookup and an all-reduce where a sharded model holds a block of the
    table's rows, `ops.tensor_parallel.embed`)."""
    return tensor_parallel.embed(
        params["audio_embeddings"], tokens + codebook * args.n_audio_vocab,
        args.n_audio_vocab * args.n_audio_codebooks)


def embed_tokens(params: Params, args: ModelArgs,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Per-slot embeddings of a (B, S, 33) frame tensor -> (B, S, 33, D):
    slots 0..31 audio, offset into the fused table; slot 32 text."""
    text = tensor_parallel.embed(params["text_embeddings"],
                                 tokens[:, :, -1], args.n_text_vocab)
    offsets = torch.arange(args.n_audio_codebooks, device=tokens.device,
                           dtype=tokens.dtype) * args.n_audio_vocab
    audio = tensor_parallel.embed(
        params["audio_embeddings"], tokens[:, :, :-1] + offsets,
        args.n_audio_vocab * args.n_audio_codebooks)
    return torch.cat([audio, text[:, :, None, :]], dim=-2)


def codebook0_logits(params: Params, args: ModelArgs,
                     hidden: torch.Tensor) -> torch.Tensor:
    """Codebook-0 logits (B, V) of the backbone's hidden state; where a
    sharded model holds a block of the head's vocabulary, its local
    logits all-gathered over the model axis."""
    head = params["codebook0_head"]
    sharded = (tensor_parallel.engages(head)
               and tensor_parallel.shard_of(args.n_audio_vocab) is not None)
    y = linear(head, hidden, "out" if sharded else None)
    return tensor_parallel.all_gather_last(y) if sharded else y


def masked_input_embeds(params: Params, args: ModelArgs, tokens: torch.Tensor,
                        token_mask: torch.Tensor) -> torch.Tensor:
    """Masked sum over the 33 slots -> backbone input (B, S, D)."""
    emb = embed_tokens(params, args, tokens)
    return (emb * token_mask[..., None].to(emb.dtype)).sum(dim=-2)


class CSM:
    """Model object: `args`, `params` (nested dict of tensors), `dtype`,
    `device`. The device is `device` if given, else that of `params`, else
    `cuda` (a RuntimeError without a GPU: pass `device="cpu"`).
    `frame_steps` holds the model's captured frame steps by configuration
    (`generation.FrameStep`, on the card), at most 4, each with its
    backbone KV cache and its CUDA graph's memory pool;
    `frame_steps.clear()` releases them."""

    def __init__(
        self,
        args: ModelArgs,
        params: Optional[Params] = None,
        dtype=torch.bfloat16,
        generator: Optional[torch.Generator] = None,
        device: torch.device | str | None = None,
    ):
        self.args = args
        self.n_audio_codebooks = args.n_audio_codebooks
        self.dtype = dtype
        self.device = resolve_device(device, params)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0)
            params = init_csm_params(generator, args, dtype, self.device)
        self.params = params
        self.frame_steps: dict = {}

    def load_weights(self, path: str, strict: bool = True) -> "CSM":
        """Load a safetensors checkpoint (reference names) in the model's
        dtype onto its device; strict=False merges into the current
        params (see `loaders.load_csm_weights`)."""
        from csm_mlx_tpu_torch.loaders import load_csm_weights

        self.params = load_csm_weights(path, dtype=self.dtype, strict=strict,
                                       existing=self.params,
                                       device=self.device)
        return self

    def save_weights(self, path: str) -> None:
        from csm_mlx_tpu_torch.loaders import save_csm_weights

        save_csm_weights(path, self.params)

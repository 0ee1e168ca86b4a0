"""Autoregressive text-to-speech generation (port of `csm_mlx_tpu/generation.py`).

The JAX package compiles the whole generation into one XLA program
(`lax.while_loop` over frames, `lax.scan` over the decoder steps). The port
runs eagerly: a Python frame loop over the same building blocks —
`_prefill`, `_backbone_step`, `_decode_frame` (c0 from `codebook0_head`,
then the decoder primed with [backbone hidden, c0 embedding] and 30
single-token decoder steps scored against `audio_head[i-1]`) — with the
same per-row all-zero-frame EOS. With the whole-frame decoder's tables in
the params (`quantize_model` on CUDA prepares them), codebooks 1..31 of a
frame come from one kernel-3 launch per chunk of <= 64 rows, as in the JAX
package; without them (or with a custom sampler) from the dispatched
decoder, a Python loop of eager steps.

Prompts are left-padded to the same buckets as in the JAX package, so a
prompt gets the same positions and masks on both sides. Prefill runs the
flash-prefill kernel on CUDA for buckets of >= 256 rows (multiples of 128)
unless `CSM_TPU_FLASH_PREFILL=0`, the masked `sdpa` otherwise. A backbone
step runs the flash-decode kernel when the caller sets
`flash_decode_min_b` and the batch reaches it (off by default, as in JAX).

Not ported yet: streaming, context audio, long-form generation and the
watermark.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from csm_mlx_tpu_torch.models.csm import (CSM, ModelArgs, embed_audio,
                                          masked_input_embeds)
from csm_mlx_tpu_torch.models.llama import llama_forward
from csm_mlx_tpu_torch.ops import resident_decoder
from csm_mlx_tpu_torch.ops.attention import (NEG_INF, causal_mask_bias,
                                             key_validity_bias)
from csm_mlx_tpu_torch.ops.kv_cache import KVCache
from csm_mlx_tpu_torch.ops.layers import emb_table, linear
from csm_mlx_tpu_torch.ops.quant import audio_head_logits
from csm_mlx_tpu_torch.ops.rope import rope_cache_for
from csm_mlx_tpu_torch.ops.sampling import (HISTORY_SIZE, SamplerConfig,
                                            apply_processors)

PROMPT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
FRAME_MS = 80  # one RVQ frame = 80 ms of audio


def prompt_bucket(length: int) -> int:
    for b in PROMPT_BUCKETS:
        if length <= b:
            return b
    return length


def _prefill(params, args: ModelArgs, tokens, token_mask, pad_len,
             cache: KVCache, cos_b, sin_b):
    """Full-prompt backbone forward; returns (last_hidden (B, D), cache)."""
    bcfg = args.backbone_config
    b, p, _ = tokens.shape
    device = tokens.device
    embeds = masked_input_embeds(params, args, tokens, token_mask)
    pad_len = pad_len.reshape(-1)
    positions = torch.arange(p, device=device)[None, :] - pad_len[:, None]
    # As in the JAX package, CSM_TPU_FLASH_PREFILL=0 keeps long prompts on
    # the masked path too.
    if device.type == "cuda" and p >= 256 and p % 128 == 0 \
            and os.environ.get("CSM_TPU_FLASH_PREFILL", "1") == "1":
        hidden, cache = llama_forward(params["backbone"], bcfg, embeds, cos_b,
                                      sin_b, positions, None, cache,
                                      flash_pad_len=pad_len)
        return hidden[:, -1, :], cache
    # Keys span the whole cache: causal over the prompt, unwritten slots and
    # left-pad slots masked.
    cap = cache.capacity
    causal = causal_mask_bias(p, cap, device=device)
    key_valid = torch.arange(cap, device=device)[None, :] >= pad_len[:, None]
    mask_bias = torch.clamp(
        causal[None, None] + key_validity_bias(key_valid)[:, None], min=NEG_INF)
    hidden, cache = llama_forward(params["backbone"], bcfg, embeds, cos_b,
                                  sin_b, positions, mask_bias, cache)
    return hidden[:, -1, :], cache


def _backbone_step(params, args: ModelArgs, tokens, token_mask, pad_len,
                   cache: KVCache, cos_b, sin_b,
                   flash_decode_min_b: Optional[int] = None):
    """One-frame backbone decode step. tokens: (B, 1, 33). With
    `flash_decode_min_b` set and B >= it, attention runs kernel 4."""
    bcfg = args.backbone_config
    device = tokens.device
    pad_len = pad_len.reshape(-1, 1)
    embeds = masked_input_embeds(params, args, tokens, token_mask)
    positions = cache.index - pad_len  # (B, 1)
    k_idx = torch.arange(cache.capacity, device=device)[None]
    key_valid = (k_idx >= pad_len) & (k_idx <= cache.index)
    mask_bias = key_validity_bias(key_valid)[:, None]
    hidden, cache = llama_forward(params["backbone"], bcfg, embeds, cos_b,
                                  sin_b, positions, mask_bias, cache,
                                  decode_pad_len=pad_len.reshape(-1),
                                  flash_decode_min_b=flash_decode_min_b)
    return hidden[:, -1, :], cache


def _use_resident_decoder(params, sampler, b: int) -> int:
    """Kernel launches per frame for the whole-frame decoder: 0 when it
    cannot serve (no prepared tables, or a custom sampler), else the number
    of chunks of <= RESIDENT_MAX_BATCH rows the batch splits into."""
    if "_resident" not in params \
            or not resident_decoder.sampler_supported(sampler):
        return 0
    return -(-b // resident_decoder.RESIDENT_MAX_BATCH)


def _decode_frame(params, args: ModelArgs, last_hidden, generator, history,
                  sampler, processors: Tuple, cos_d, sin_d):
    """Sample the 32 codebooks of one frame from the backbone hidden state:
    c0 through the sampler and processor chain, codebooks 1..31 through
    the decoder with plain temperature sampling — the whole-frame kernel
    when the params carry its tables, else the dispatched decoder.
    Returns (frame (B, 32), history)."""
    b = last_hidden.shape[0]
    device = last_hidden.device

    c0_logits = linear(params["codebook0_head"], last_hidden).float()
    c0_logits = apply_processors(processors, history, c0_logits)
    c0 = sampler(generator, c0_logits)
    history = torch.roll(history, -1, dims=-1)
    history[:, -1] = c0

    c0_emb = embed_audio(params, args, 0, c0).to(last_hidden.dtype)
    x01 = torch.stack([last_hidden, c0_emb], dim=1)  # (B, 2, D_backbone)
    proj01 = linear(params["projection"], x01)

    n_chunks = _use_resident_decoder(params, sampler, b)
    if n_chunks:
        # One kernel-3 launch per chunk (the plain version on the CPU);
        # c0, its processors and the projection stay outside, as in JAX.
        t = sampler.temperature
        proj01_t = proj01.float().transpose(0, 1)  # (2, B, d_decoder)
        cs = -(-b // n_chunks)
        seed_device = device if generator is None else generator.device
        parts = []
        for lo in range(0, b, cs):
            # one int32 seed per chunk from the caller's generator
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     device=seed_device)) if t > 0.0 else 0
            parts.append(resident_decoder.resident_decode_frame(
                params["_resident"], args, proj01_t[:, lo:lo + cs], seed, t))
        toks = torch.cat(parts, dim=1)  # (n_cb, B)
        frame = torch.cat([c0[:, None], toks[1:].t().long()], dim=1)
        return frame, history

    dec_sampler = (SamplerConfig(temperature=sampler.temperature)
                   if type(sampler) is SamplerConfig else sampler)
    codes, _ = dispatched_decode(params, args, proj01, dec_sampler,
                                 generator, cos_d, sin_d)
    return torch.cat([c0[:, None], codes], dim=1), history


def dispatched_decode(params, args: ModelArgs, proj01, dec_sampler,
                      generator, cos_d, sin_d, forced=None):
    """The dispatched decoder: a fresh 33-slot cache primed with proj01
    (B, 2, d_decoder), then one eager llama step per codebook, scored
    against `audio_head[i-1]`. Returns (codes (B, n_cb-1) of codebooks
    1..n_cb-1, logits (n_cb-1, B, V) f32). With `forced` (B, n_cb), step i
    reads the embedding of forced[:, i-1] instead of its own pick (teacher
    forcing); the returned codes stay its picks."""
    dcfg = args.decoder_config
    b, n_cb = proj01.shape[0], args.n_audio_codebooks
    device, dtype = proj01.device, proj01.dtype
    audio_head = params["audio_head"]
    cap = n_cb + 1
    dcache = KVCache.init(dcfg, b, cap, dtype=dtype, device=device)

    def dec_bias(q_len, index):
        return causal_mask_bias(q_len, cap, q_offset=index,
                                device=device)[None, None]

    hidden, dcache = llama_forward(
        params["decoder"], dcfg, proj01, cos_d, sin_d,
        torch.arange(2, device=device)[None], dec_bias(2, 0), dcache)
    logits = [audio_head_logits(audio_head, 0, hidden[:, -1])]
    codes = [dec_sampler(generator, logits[0])]
    table = emb_table(params["audio_embeddings"])
    for i in range(2, n_cb):
        prev = codes[-1] if forced is None else forced[:, i - 1]
        emb = table[prev + (i - 1) * args.n_audio_vocab].to(dtype)
        x = linear(params["projection"], emb[:, None, :])
        positions = torch.full((1, 1), dcache.index, device=device)
        hidden, dcache = llama_forward(params["decoder"], dcfg, x, cos_d,
                                       sin_d, positions,
                                       dec_bias(1, dcache.index), dcache)
        logits.append(audio_head_logits(audio_head, i - 1, hidden[:, 0]))
        codes.append(dec_sampler(generator, logits[-1]))
    return torch.stack(codes, dim=1), torch.stack(logits).float()


def _frame_to_next_input(frame):
    """A sampled frame as the next (B, 1, 33) input and mask: audio slots
    = frame, text slot = 0 and unmasked."""
    zeros = torch.zeros_like(frame[:, :1])
    tokens = torch.cat([frame, zeros], dim=1)[:, None, :]
    mask = torch.cat([torch.ones_like(frame), zeros], dim=1)[:, None, :]
    return tokens, mask


def _pad_prompt(prompt: np.ndarray, mask: np.ndarray) -> tuple:
    """Left-pad to the bucket size; returns (tokens (1, P, 33), mask,
    pad_len (1,), bucket)."""
    s = prompt.shape[0]
    bucket = prompt_bucket(s)
    pad = bucket - s
    tokens = np.zeros((1, bucket, prompt.shape[1]), dtype=np.int32)
    m = np.zeros((1, bucket, prompt.shape[1]), dtype=np.int32)
    tokens[0, pad:] = prompt
    m[0, pad:] = mask
    return tokens, m, np.asarray([pad], dtype=np.int32), bucket


def _check_context_window(args: ModelArgs, prompt_len: int,
                          max_frames: int) -> None:
    context_window = args.backbone_config.max_position_embeddings or 2048
    max_seq_len = context_window - max_frames
    if prompt_len >= max_seq_len:
        raise ValueError(
            f"Inputs too long ({prompt_len}), must be below max_seq_len - "
            f"max_audio_frames: {max_seq_len}")


def _resolve_sampler(temperature: float, sampler: Optional[Any]):
    return SamplerConfig(temperature=temperature) if sampler is None \
        else sampler


@torch.no_grad()
def _generate_padded(model: CSM, tokens: np.ndarray, mask: np.ndarray,
                     pad_len: np.ndarray, bucket: int, max_frames: int,
                     sampler, processors: Tuple,
                     generator: Optional[torch.Generator],
                     flash_decode_min_b: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The frame loop over a left-padded batch; returns (frames
    (max_frames, B, 32) int32, n_frames (B,) int32). A row stops counting
    frames at its first all-zero frame; the loop ends when every row has
    stopped or after max_frames. Backbone steps of B >= `flash_decode_min_b`
    rows run their attention through kernel 4 (None: never)."""
    args = model.args
    device = model.device
    bcfg, dcfg = args.backbone_config, args.decoder_config
    b = tokens.shape[0]
    capacity = bucket + max_frames
    cos_b, sin_b = rope_cache_for(
        bcfg, max(capacity, bcfg.max_position_embeddings), device)
    cos_d, sin_d = rope_cache_for(dcfg, args.n_audio_codebooks + 1, device)
    t = torch.from_numpy(tokens).long().to(device)
    m = torch.from_numpy(mask).long().to(device)
    pad = torch.from_numpy(pad_len).long().to(device)

    cache = KVCache.init(bcfg, b, capacity, dtype=model.dtype, device=device)
    last_hidden, cache = _prefill(model.params, args, t, m, pad, cache,
                                  cos_b, sin_b)
    history = torch.full((b, HISTORY_SIZE), -1, dtype=torch.long,
                         device=device)
    frames = torch.zeros((max_frames, b, args.n_audio_codebooks),
                         dtype=torch.long, device=device)
    n_frames = torch.zeros((b,), dtype=torch.long, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    for i in range(max_frames):
        frame, history = _decode_frame(model.params, args, last_hidden,
                                       generator, history, sampler,
                                       processors, cos_d, sin_d)
        done = done | (frame == 0).all(dim=1)
        frames[i] = frame
        n_frames = torch.where(done, n_frames, i + 1)
        if bool(done.all()) or i + 1 == max_frames:
            break
        nxt_tokens, nxt_mask = _frame_to_next_input(frame)
        last_hidden, cache = _backbone_step(model.params, args, nxt_tokens,
                                            nxt_mask, pad, cache, cos_b,
                                            sin_b, flash_decode_min_b)
    return (frames.to(torch.int32).cpu().numpy(),
            n_frames.to(torch.int32).cpu().numpy())


def generate_tokens(
    model: CSM,
    prompt: np.ndarray,
    prompt_mask: np.ndarray,
    max_audio_frames: int,
    *,
    temperature: float = 0.8,
    sampler: Optional[Any] = None,
    logits_processors: Optional[Sequence] = None,
    generator: Optional[torch.Generator] = None,
    flash_decode_min_b: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """One (S, 33) prompt -> (frames (F, 32) int32, F). `flash_decode_min_b`
    as in `generate_tokens_batch`: one row takes kernel 4 only at 1."""
    _check_context_window(model.args, prompt.shape[0], max_audio_frames)
    tokens, mask, pad_len, bucket = _pad_prompt(prompt, prompt_mask)
    frames, n = _generate_padded(
        model, tokens, mask, pad_len, bucket, max_audio_frames,
        _resolve_sampler(temperature, sampler),
        tuple(logits_processors or ()), generator, flash_decode_min_b)
    n = int(n[0])
    return frames[:n, 0, :], n


def generate_tokens_batch(
    model: CSM,
    prompts: Sequence[np.ndarray],
    prompt_masks: Sequence[np.ndarray],
    max_audio_frames: int,
    *,
    temperature: float = 0.8,
    sampler: Optional[Any] = None,
    logits_processors: Optional[Sequence] = None,
    generator: Optional[torch.Generator] = None,
    flash_decode_min_b: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Prompts left-padded to a common bucket; each row stops at its own
    all-zero frame. Returns (frames (max_frames, B, 32), n_frames (B,)).

    `flash_decode_min_b`: at B >= it, each backbone step's attention runs
    the flash-decode kernel (`ops.attention.flash_decode_sdpa`, kernel 4)
    instead of the masked `sdpa`; None (the default) keeps it off, as the
    JAX package's `CSM_TPU_FLASH_DECODE` is off by default (which gates at
    `CSM_TPU_FLASH_DECODE_MIN_B`, 8). The decoder never takes it."""
    b = len(prompts)
    longest = max(p.shape[0] for p in prompts)
    _check_context_window(model.args, longest, max_audio_frames)
    bucket = prompt_bucket(longest)
    n_slots = prompts[0].shape[1]
    tokens = np.zeros((b, bucket, n_slots), dtype=np.int32)
    mask = np.zeros((b, bucket, n_slots), dtype=np.int32)
    pad_len = np.zeros((b,), dtype=np.int32)
    for i, (p, m) in enumerate(zip(prompts, prompt_masks)):
        pad = bucket - p.shape[0]
        tokens[i, pad:] = p
        mask[i, pad:] = m
        pad_len[i] = pad
    return _generate_padded(
        model, tokens, mask, pad_len, bucket, max_audio_frames,
        _resolve_sampler(temperature, sampler),
        tuple(logits_processors or ()), generator, flash_decode_min_b)


def generate(
    model: CSM,
    text: str,
    speaker: int,
    context: Sequence = (),
    max_audio_length_ms: float = 90_000,
    *,
    temperature: float = 0.8,
    sampler: Optional[Any] = None,
    logits_processors: Optional[Sequence] = None,
    generator: Optional[torch.Generator] = None,
    mimi=None,
) -> torch.Tensor:
    """Text -> 24 kHz waveform (1-D tensor), in JAX's argument order.

    The text goes through the canonical tokenizer
    (`tokenizers.get_text_tokenizer`: a local path installed earlier or
    `CSM_TPU_TEXT_TOKENIZER`); `mimi` is the codec, by default the
    `get_audio_tokenizer` singleton on the model's device. Context audio
    needs the Mimi encoder, not ported yet: a non-empty `context` raises."""
    from csm_mlx_tpu_torch.tokenizers import (get_audio_tokenizer,
                                              tokenize_text_segment)

    if len(context):
        raise NotImplementedError(
            "generate with context segments needs the Mimi encoder, not "
            "ported yet (ROADMAP queue 1, item 5)")
    max_frames = int(max_audio_length_ms / FRAME_MS)
    prompt, mask = tokenize_text_segment(text, speaker,
                                         model.n_audio_codebooks)
    frames, n = generate_tokens(
        model, prompt, mask, max_frames, temperature=temperature,
        sampler=sampler, logits_processors=logits_processors,
        generator=generator)
    if n == 0:
        return torch.zeros((0,), dtype=torch.float32)
    if mimi is None:
        mimi = get_audio_tokenizer(model.n_audio_codebooks,
                                   device=model.device)
    codes = torch.from_numpy(frames.T[None].copy()).long()  # (1, K, F)
    return mimi.decode(codes)[0, 0]

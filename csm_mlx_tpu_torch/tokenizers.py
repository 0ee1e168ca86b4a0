"""Prompt frames and the codec singleton (port of `csm_mlx_tpu/tokenizers.py`).

The Llama-3.2 text tokenizer is read from a LOCAL path only (a directory
holding `tokenizer.json`, or the file itself) with the `tokenizers`
package, imported when first needed; the BOS/EOS template of the JAX
package is applied. Tokens of "[speaker]text" go in column 32 of an
(S, 33) frame, Mimi's codes of a turn's audio in columns 0-31 (one row a
frame, and an all-zero EOS frame), each with a parallel 0/1 mask;
`tokenize_segments_with_loss_mask` builds a conversation's rows and loss
mask, `decode_audio` turns codes back into audio.

As in the JAX package, `get_text_tokenizer` and `get_audio_tokenizer` keep
one canonical instance each: a startup call with an explicit path installs
the instance that later calls without one (`tokenize_text_segment`, and
`generate` with no codec) share. Paths resolve from the argument, else the
`CSM_TPU_TEXT_TOKENIZER` / `CSM_TPU_MIMI_WEIGHTS` variables; nothing is
downloaded.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

BOS = "<|begin_of_text|>"
EOS = "<|end_of_text|>"
TEXT_TOKENIZER_ENV = "CSM_TPU_TEXT_TOKENIZER"
MIMI_WEIGHTS_ENV = "CSM_TPU_MIMI_WEIGHTS"


def _special_token(config: dict, key: str, default: str) -> str:
    tok = config.get(key, default)
    return tok["content"] if isinstance(tok, dict) else tok


def _load_text_tokenizer(path: str):
    """A `tokenizers.Tokenizer` with the single-sequence BOS/EOS template."""
    from tokenizers import Tokenizer
    from tokenizers.processors import TemplateProcessing

    p = Path(path)
    file = p / "tokenizer.json" if p.is_dir() else p
    if not file.exists():
        raise FileNotFoundError(f"text tokenizer not found: {file}")
    tokenizer = Tokenizer.from_file(str(file))
    bos, eos = BOS, EOS
    config_file = file.with_name("tokenizer_config.json")
    if config_file.exists():
        config = json.loads(config_file.read_text())
        bos = _special_token(config, "bos_token", BOS)
        eos = _special_token(config, "eos_token", EOS)
    tokenizer.post_processor = TemplateProcessing(
        single=f"{bos}:0 $A:0 {eos}:0",
        pair=f"{bos}:0 $A:0 {eos}:0 {bos}:1 $B:1 {eos}:1",
        special_tokens=[(bos, tokenizer.token_to_id(bos)),
                        (eos, tokenizer.token_to_id(eos))],
    )
    return tokenizer


_TEXT_TOK_CACHE: dict = {}  # "tok" -> (source path, tokenizer)


def get_text_tokenizer(path: Optional[str] = None):
    """The canonical text tokenizer. `path`, else `CSM_TPU_TEXT_TOKENIZER`:
    a given path that does not exist raises; a call without either returns
    the installed instance, and raises naming the variable when there is
    none (no hub download)."""
    src = path or os.environ.get(TEXT_TOKENIZER_ENV)
    cached = _TEXT_TOK_CACHE.get("tok")
    if cached is not None and (path is None or cached[0] == src):
        return cached[1]
    if src is None:
        raise FileNotFoundError(
            f"no text tokenizer: pass a local path to get_text_tokenizer or "
            f"set {TEXT_TOKENIZER_ENV} (nothing is downloaded)")
    tokenizer = _load_text_tokenizer(src)
    _TEXT_TOK_CACHE["tok"] = (src, tokenizer)
    return tokenizer


get_text_tokenizer.cache_clear = _TEXT_TOK_CACHE.clear


_MIMI_CACHE: dict = {}  # (n_codebooks, device) -> (weights path | None, Mimi)


def _codec_device(device) -> torch.device:
    """The cache's device key: an indexed device for CUDA (`cuda` is the
    current card, so "cuda" and "cuda:0" name one instance), `cpu` for the
    CPU."""
    from csm_mlx_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev


def get_audio_tokenizer(n_audio_codebooks: int = 32,
                        weights: Optional[str] = None, *, device=None):
    """The Mimi codec singleton of a codebook count (and device, default
    `cuda`). A path (`weights`, else `CSM_TPU_MIMI_WEIGHTS`) is a local
    checkpoint, loaded by `models.mimi.weights.load_mimi_checkpoint`: a
    path that does not exist raises FileNotFoundError, a file the loader
    cannot read raises its error, and no random-init codec is put in its
    place. A startup call with a path installs the instance that later
    calls without one share; a call on another device loads that same
    path there. Only when no path is known for the count, a random-init
    codec from seed 0, as the JAX package makes when none resolves: two
    inconsistent codecs of one count never sit in the cache together."""
    from csm_mlx_tpu_torch.models.mimi import Mimi, mimi_202407
    from csm_mlx_tpu_torch.models.mimi.weights import load_mimi_checkpoint

    path = weights or os.environ.get(MIMI_WEIGHTS_ENV)
    if path is not None and not os.path.exists(path):
        raise FileNotFoundError(
            f"Mimi weights not found: {path!r} (from the weights argument "
            f"or {MIMI_WEIGHTS_ENV}); refusing to fall back to a random-init "
            f"codec")
    key = (n_audio_codebooks, str(_codec_device(device)))
    cached = _MIMI_CACHE.get(key)
    if path is None:
        if cached is not None:
            return cached[1]
        # the path installed on another device, if any
        path = next((p for (n, _), (p, _) in _MIMI_CACHE.items()
                     if n == n_audio_codebooks and p is not None), None)
    elif cached is not None and cached[0] == path:
        return cached[1]
    cfg = mimi_202407(n_audio_codebooks)
    params = None if path is None else load_mimi_checkpoint(
        path, cfg, device=key[1])
    for k in [k for k, (p, _) in _MIMI_CACHE.items()
              if k[0] == n_audio_codebooks and p != path]:
        del _MIMI_CACHE[k]  # another source's instance on another device
    _MIMI_CACHE[key] = (path, Mimi(cfg, params=params, device=key[1]))
    return _MIMI_CACHE[key][1]


get_audio_tokenizer.cache_clear = _MIMI_CACHE.clear


def tokenize_text_segment(text: str, speaker: int, n_audio_codebooks: int = 32
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """"[speaker]text" -> ((S, K+1) frame, mask), text in the last column,
    with the canonical text tokenizer (`get_text_tokenizer()`)."""
    ids = get_text_tokenizer().encode(f"[{speaker}]{text}").ids
    s = len(ids)
    frame = np.zeros((s, n_audio_codebooks + 1), dtype=np.int32)
    mask = np.zeros((s, n_audio_codebooks + 1), dtype=np.int32)
    frame[:, -1] = np.asarray(ids, dtype=np.int32)
    mask[:, -1] = 1
    return frame, mask


def _codec(n_audio_codebooks: int, mimi):
    return mimi if mimi is not None else get_audio_tokenizer(n_audio_codebooks)


def tokenize_audio(audio, *, n_audio_codebooks: int = 32, mimi=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """24 kHz mono audio -> ((F+1, K+1) frames with the all-zero EOS frame,
    mask), through the codec `mimi`, by default the singleton on the
    card."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 0 or sum(d > 1 for d in audio.shape) > 1:
        # a blind reshape(-1) would interleave stereo channels into one
        # double-speed waveform and encode it without any error
        raise ValueError(
            f"tokenize_audio expects mono 1-D audio, got shape "
            f"{audio.shape}; downmix or select a channel first")
    codec = _codec(n_audio_codebooks, mimi)
    codes = codec.encode(torch.from_numpy(audio.reshape(1, 1, -1)))[0]
    codes = codes.to(torch.int32).cpu().numpy()  # (K, F)
    f = codes.shape[1] + 1  # and the EOS frame
    frame = np.zeros((f, n_audio_codebooks + 1), dtype=np.int32)
    mask = np.zeros((f, n_audio_codebooks + 1), dtype=np.int32)
    frame[:-1, :-1] = codes.T
    mask[:, :-1] = 1
    return frame, mask


def tokenize_segment(segment, *, n_audio_codebooks: int = 32, mimi=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """A turn's text rows, then its audio rows -> ((S, K+1), mask)."""
    text_tokens, text_masks = tokenize_text_segment(
        segment.text, segment.speaker, n_audio_codebooks)
    audio_tokens, audio_masks = tokenize_audio(
        segment.audio, n_audio_codebooks=n_audio_codebooks, mimi=mimi)
    return (np.concatenate([text_tokens, audio_tokens]).astype(np.int32),
            np.concatenate([text_masks, audio_masks]).astype(np.int32))


def tokenize_segments_with_loss_mask(
        segments: List, *, n_audio_codebooks: int = 32,
        mask_speaker_ids: List[int], max_audio_length_ms: Optional[int],
        mimi=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A conversation's turns, concatenated -> (tokens, masks, loss masks);
    the loss mask is 0 on the rows of `mask_speaker_ids`' turns, and every
    array is cut to max_audio_length_ms / 80 rows."""
    tokens_list, masks_list = zip(*[
        tokenize_segment(s, n_audio_codebooks=n_audio_codebooks, mimi=mimi)
        for s in segments])
    tokens = np.concatenate(tokens_list, axis=0)
    masks = np.concatenate(masks_list, axis=0)
    loss_masks = np.ones_like(tokens)
    pos = 0
    for seg_tokens, segment in zip(tokens_list, segments):
        n = seg_tokens.shape[0]
        if segment.speaker in mask_speaker_ids:
            loss_masks[pos:pos + n] = 0
        pos += n
    if max_audio_length_ms is not None:
        max_rows = int(max_audio_length_ms / 80)
        tokens = tokens[:max_rows]
        masks = masks[:max_rows]
        loss_masks = loss_masks[:max_rows]
    return tokens, masks, loss_masks


def decode_audio(audio_tokens, *, n_audio_codebooks: int = 32, mimi=None
                 ) -> torch.Tensor:
    """(B, K, F) codes -> (B, 1, F * frame_size) waveform, through the codec
    `mimi`, by default the singleton on the card."""
    return _codec(n_audio_codebooks, mimi).decode(audio_tokens)

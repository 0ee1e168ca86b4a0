"""Text frames for the prompt and the codec singleton (port of
`csm_mlx_tpu/tokenizers.py`, without the Mimi encoder).

The Llama-3.2 text tokenizer is read from a LOCAL path only (a directory
holding `tokenizer.json`, or the file itself) with the `tokenizers`
package, imported when first needed; the BOS/EOS template of the JAX
package is applied. Tokens of "[speaker]text" go in column 32 of an
(S, 33) frame, with a parallel 0/1 mask.

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
from typing import Optional, Tuple

import numpy as np

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


_MIMI_CACHE: dict = {}  # (n_codebooks, device) -> Mimi


def get_audio_tokenizer(n_audio_codebooks: int = 32,
                        weights: Optional[str] = None, *, device=None):
    """The Mimi codec singleton of a codebook count (and device, default
    `cuda`). Random-init from seed 0 when no weights are given, as the JAX
    package does when none resolve. A given path (`weights`, else
    `CSM_TPU_MIMI_WEIGHTS`) that does not exist raises FileNotFoundError;
    one that exists raises NotImplementedError until the checkpoint loader
    is ported (ROADMAP queue 1, item 3)."""
    from csm_mlx_tpu_torch.device import resolve_device
    from csm_mlx_tpu_torch.models.mimi import Mimi, mimi_202407

    path = weights or os.environ.get(MIMI_WEIGHTS_ENV)
    if path is not None:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"Mimi weights not found: {path!r} (from the weights argument "
                f"or {MIMI_WEIGHTS_ENV}); refusing to fall back to a "
                f"random-init codec")
        raise NotImplementedError(
            f"loading Mimi weights ({path!r}) is not ported yet (ROADMAP "
            f"queue 1, item 3: load_mimi_checkpoint)")
    key = (n_audio_codebooks, str(resolve_device(device)))
    if key not in _MIMI_CACHE:
        _MIMI_CACHE[key] = Mimi(mimi_202407(n_audio_codebooks),
                                device=key[1])
    return _MIMI_CACHE[key]


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

"""Text frames for the prompt (port of the text half of `csm_mlx_tpu/tokenizers.py`).

The Llama-3.2 text tokenizer is read from a LOCAL path only (a directory
holding `tokenizer.json`, or the file itself) with the `tokenizers`
package, imported when first needed; the BOS/EOS template of the JAX
package is applied. Tokens of "[speaker]text" go in column 32 of an
(S, 33) frame, with a parallel 0/1 mask.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

BOS = "<|begin_of_text|>"
EOS = "<|end_of_text|>"


def _special_token(config: dict, key: str, default: str) -> str:
    tok = config.get(key, default)
    return tok["content"] if isinstance(tok, dict) else tok


def get_text_tokenizer(path: str):
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


def tokenize_text_segment(text: str, speaker: int, tokenizer_path: str,
                          n_audio_codebooks: int = 32
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """"[speaker]text" -> ((S, K+1) frame, mask), text in the last column."""
    ids = get_text_tokenizer(tokenizer_path).encode(f"[{speaker}]{text}").ids
    s = len(ids)
    frame = np.zeros((s, n_audio_codebooks + 1), dtype=np.int32)
    mask = np.zeros((s, n_audio_codebooks + 1), dtype=np.int32)
    frame[:, -1] = np.asarray(ids, dtype=np.int32)
    mask[:, -1] = 1
    return frame, mask

"""The voice chat's sentence splitter (copy of the part of
`csm_mlx_tpu/apps/voice_chat.py` that long-form generation uses). The rest
of the app is not ported yet (ROADMAP queue 1, item 10)."""

from __future__ import annotations

import re
from typing import List

_SENTENCE_END_RE = re.compile(r"([.!?…][\"')\]]?)(\s+|$)")


def split_sentences(text: str) -> List[str]:
    """Sentence-boundary split for incremental TTS."""
    out, pos = [], 0
    for m in _SENTENCE_END_RE.finditer(text):
        out.append(text[pos:m.end(1)].strip())
        pos = m.end()
    rest = text[pos:].strip()
    if rest:
        out.append(rest)
    return [s for s in out if s]

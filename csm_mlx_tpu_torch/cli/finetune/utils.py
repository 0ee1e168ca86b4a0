"""Filename helpers for the dataset-convert command (a copy of
`csm_mlx_tpu/cli/finetune/utils.py`, not an import: the port imports
nothing of the JAX package). Conversation files sort in human order
("turn2" before "turn10"), and a speaker id is recovered from a
`speaker<N>` tag anywhere in the name (case-insensitive) so
`a_speaker0.wav` / `B_SPEAKER12.txt` both resolve.
"""

from __future__ import annotations

import re
from typing import List, Optional, Union

_DIGIT_RUNS = re.compile(r"(\d+)")
_SPEAKER_TAG = re.compile(r"speaker(\d+)", re.IGNORECASE)


def natural_sort_key(name: str) -> List[Union[int, str]]:
    """Sort key treating digit runs numerically and letters case-folded."""
    parts = _DIGIT_RUNS.split(name)
    return [int(p) if p.isdigit() else p.lower() for p in parts]


def find_speaker_id(filename: str) -> Optional[int]:
    """First `speaker<digits>` tag in the filename, or None."""
    tag = _SPEAKER_TAG.search(filename)
    return int(tag.group(1)) if tag else None

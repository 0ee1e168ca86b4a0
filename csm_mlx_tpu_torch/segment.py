"""Conversation segment (port of `csm_mlx_tpu/segment.py`).

One turn: (speaker, text, audio | audio_path). Audio given as a path is
read, mixed to mono and resampled to 24 kHz (`utils.audio.read_audio`) the
first time it is asked for, and kept: a long synthesis re-reads its
context segments on every `generate` call.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

SAMPLING_RATE = 24000


class Segment:
    def __init__(self, speaker: int, text: str,
                 audio: Optional[np.ndarray] = None,
                 audio_path: Optional[Path] = None):
        if audio is None and audio_path is None:
            raise ValueError("Either 'audio' or 'audio_path' must be provided")
        self.speaker = speaker
        self.text = text
        self._audio = np.asarray(audio) if audio is not None else None
        self.audio_path = Path(audio_path) if audio_path is not None else None

    @property
    def audio(self) -> np.ndarray:
        if self._audio is not None:
            return self._audio
        if self.audio_path is not None:
            from csm_mlx_tpu_torch.utils.audio import read_audio

            self._audio = read_audio(self.audio_path, SAMPLING_RATE)
            return self._audio
        raise ValueError("Neither 'audio' nor 'audio_path' is provided")

    @audio.setter
    def audio(self, value):
        self._audio = np.asarray(value)

    def __repr__(self) -> str:
        src = "array" if self._audio is not None else str(self.audio_path)
        return f"Segment(speaker={self.speaker}, text={self.text!r}, audio={src})"

"""Streaming speech-to-text front end of the voice chat (port of
`csm_mlx_tpu/apps/stt.py`, numpy only, a copy: the port imports nothing of
the JAX package).

A lazily loaded ASR backend wrapper plus `OnlineASRProcessor`, which keeps
a growing audio buffer, runs incremental transcription, accumulates a text
prompt for conditioning, and trims the buffer to just before the last
committed point (the reference's `stt_processor.py`, itself derived from
ufal/whisper_streaming, MIT).

The commit policy is upstream whisper_streaming's **LocalAgreement-2**: a
word is committed only once two consecutive hypotheses agree on it, so text
the next pass would have revised is never sent downstream. The prompt is
accumulated from committed text that has scrolled out of the trimmed
buffer, as the reference's `prompt_update` does.

The ASR backend is pluggable (`AsrBackend` protocol): `FasterWhisperASR`
works where the faster-whisper package is installed (imported at the first
transcription); tests and offline use plug in any backend.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Protocol, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SAMPLING_RATE = 16000


class AsrWord:
    """One word with absolute-in-buffer times."""

    def __init__(self, start: float, end: float, word: str):
        self.start = start
        self.end = end
        self.word = word


class AsrSegment:
    """One transcribed segment with optional word-level timestamps."""

    def __init__(self, start: float, end: float, text: str,
                 no_speech_prob: float = 0.0,
                 words: Optional[List[AsrWord]] = None):
        self.start = start
        self.end = end
        self.text = text
        self.no_speech_prob = no_speech_prob
        self.words = words

    def word_list(self) -> List[AsrWord]:
        """Words; if the backend gave none, split the text evenly in time."""
        if self.words:
            return self.words
        toks = self.text.split()
        if not toks:
            return []
        dur = (self.end - self.start) / len(toks)
        return [AsrWord(self.start + i * dur, self.start + (i + 1) * dur, w)
                for i, w in enumerate(toks)]


class AsrBackend(Protocol):
    def transcribe(self, audio: np.ndarray, init_prompt: str = ""
                   ) -> List[AsrSegment]:
        ...


class FasterWhisperASR:
    """Lazy wrapper over faster-whisper (stt_processor.py:67-133)."""

    sep = ""

    def __init__(self, model_size: str = "large-v3", device: str = "auto",
                 compute_type: str = "auto", language: Optional[str] = "en",
                 vad_filter: bool = True):
        self.model_size = model_size
        self.device = device
        self.compute_type = compute_type
        self.language = language
        self.vad_filter = vad_filter
        self._model = None

    def _load(self):
        if self._model is None:
            from faster_whisper import WhisperModel  # optional dependency

            logger.info("Loading whisper model %s...", self.model_size)
            self._model = WhisperModel(self.model_size, device=self.device,
                                       compute_type=self.compute_type)
        return self._model

    def transcribe(self, audio: np.ndarray, init_prompt: str = ""
                   ) -> List[AsrSegment]:
        model = self._load()
        segments, _info = model.transcribe(
            audio,
            language=self.language if self.language != "auto" else None,
            initial_prompt=init_prompt,
            beam_size=5,
            word_timestamps=True,
            condition_on_previous_text=True,
            vad_filter=self.vad_filter,
        )
        out = []
        for seg in segments:
            words = [AsrWord(w.start, w.end, w.word)
                     for w in (seg.words or [])] or None
            out.append(AsrSegment(seg.start, seg.end, seg.text,
                                  getattr(seg, "no_speech_prob", 0.0), words))
        return out

    def language_detection(self, audio: np.ndarray) -> str:
        """Detect the spoken language from (up to) the first 30 s and pin it.

        Parity with the reference's ``FasterWhisperASR.language_detection``
        (stt_processor.py:125-133), with its tuple-unpack bug fixed: the
        reference assigns the whole ``(segments, info)`` return to ``info``,
        so ``info.language`` raises; here the transcribe result is unpacked.
        """
        model = self._load()
        segments, info = model.transcribe(audio[: SAMPLING_RATE * 30])
        # The language probe is lazy until the generator is touched on some
        # faster-whisper versions; info is populated eagerly, so no drain.
        del segments
        logger.info("Detected language: %s (p=%.2f)", info.language,
                    getattr(info, "language_probability", float("nan")))
        self.language = info.language
        return info.language


def _norm(word: str) -> str:
    return word.strip().lower().strip(".,!?;:\"'")


class OnlineASRProcessor:
    """Incremental transcription with LocalAgreement-2 commits.

    insert_audio_chunk() appends 16 kHz mono audio; process_iter() runs the
    backend over the buffer and commits the longest prefix of words on which
    the previous and current hypotheses agree (so one revision pass is always
    allowed before text is sent downstream); the buffer trims to the last
    committed word end - TRIM_MARGIN_S and the prompt carries the committed
    text across trims (stt_processor.py:170-230 semantics). finish() flushes
    whatever remains.
    """

    TRIM_MARGIN_S = 1.5
    NO_SPEECH_THRESHOLD = 0.9

    def __init__(self, asr: AsrBackend, buffer_trimming_sec: float = 15.0,
                 min_chunk_seconds: float = 0.0):
        self.asr = asr
        self.buffer_trimming_sec = buffer_trimming_sec
        self.min_chunk_seconds = min_chunk_seconds
        self.init()

    def init(self):
        self.audio_buffer = np.zeros((0,), dtype=np.float32)
        self.buffer_time_offset = 0.0
        self.committed: List[Tuple[float, float, str]] = []
        self.prompt_text = ""
        self._prompted_upto = 0  # committed[:k] already absorbed into prompt
        self._prev_hyp: List[AsrWord] = []   # last iteration's uncommitted tail
        self._since_last_process = 0.0

    def insert_audio_chunk(self, audio: np.ndarray):
        audio = np.asarray(audio, dtype=np.float32)
        self.audio_buffer = np.append(self.audio_buffer, audio)
        self._since_last_process += len(audio) / SAMPLING_RATE

    def _hypothesis(self) -> List[AsrWord]:
        """Transcribe the buffer -> flat word list (absolute times)."""
        segments = self.asr.transcribe(self.audio_buffer,
                                       init_prompt=self.prompt_text[-200:])
        words: List[AsrWord] = []
        for seg in segments:
            if seg.no_speech_prob > self.NO_SPEECH_THRESHOLD:
                continue
            for w in seg.word_list():
                words.append(AsrWord(w.start + self.buffer_time_offset,
                                     w.end + self.buffer_time_offset, w.word))
        return words

    def _commit(self, words: List[AsrWord]) -> str:
        for w in words:
            self.committed.append((w.start, w.end, w.word))
        return " ".join(w.word.strip() for w in words if w.word.strip())

    def _absorb_scrolled_out(self) -> None:
        """Move committed words whose audio left the buffer into the
        transcription prompt. Prompting only with SCROLLED-OUT text (the
        reference's behavior, stt_processor.py:135-254) matters: priming
        whisper with words whose audio it is about to re-hear encourages it
        to skip the buffer-initial region on the next pass."""
        new = []
        while (self._prompted_upto < len(self.committed)
               and self.committed[self._prompted_upto][1]
               <= self.buffer_time_offset):
            w = self.committed[self._prompted_upto][2].strip()
            if w:
                new.append(w)
            self._prompted_upto += 1
        if new:
            self.prompt_text = (self.prompt_text + " " + " ".join(new)).strip()

    def _drop_committed(self, hyp: List[AsrWord]) -> List[AsrWord]:
        """Drop hypothesis words already committed (the untrimmed buffer
        re-transcribes them). Midpoint-vs-frontier is robust to timestamp
        jitter (a word only survives if more than half of it lies past the
        last committed end); a leading word whose text equals the last
        committed word and overlaps it is dropped too.

        Punctuation-only tokens get a frontier-adjacency exemption: a '.'
        whose span hugs the tail of the word it follows sits at/behind the
        frontier the moment that word commits, and the plain midpoint rule
        would filter it out of every future hypothesis before the commit
        loop (which holds punctuation back until a neighbor agrees) could
        ever see it again — silently losing sentence-final punctuation."""
        if not self.committed:
            return hyp
        last_end = self.committed[-1][1]
        kept = []
        for w in hyp:
            if (w.start + w.end) / 2 > last_end:
                kept.append(w)
            elif (_norm(w.word) == "" and w.end > last_end - 0.3
                    and not self._punct_already_committed(w)):
                kept.append(w)
        hyp = kept
        last_norm = _norm(self.committed[-1][2])
        while hyp and _norm(hyp[0].word) == last_norm \
                and hyp[0].start < last_end:
            hyp = hyp[1:]
        return hyp

    def _punct_already_committed(self, w: AsrWord) -> bool:
        """True when a committed token already covers this punctuation
        (same text, overlapping span) — re-keeping it would duplicate it."""
        ws = w.word.strip()
        for cs, ce, cw in self.committed[-4:]:
            if cw.strip() == ws and w.start < ce + 0.05 and w.end > cs - 0.05:
                return True
        return False

    def process_iter(self) -> str:
        """Return newly agreed-upon text ("" if none yet)."""
        if len(self.audio_buffer) < SAMPLING_RATE // 2:
            return ""
        if self._since_last_process < self.min_chunk_seconds:
            return ""
        self._since_last_process = 0.0

        hyp = self._drop_committed(self._hypothesis())
        # LocalAgreement-2: commit the longest common prefix (by normalized
        # word) of the previous and current hypotheses. Punctuation-only
        # tokens (empty after normalization) consume only the *current*
        # position — pairing them against a previous word would shift the
        # comparison — and EVERY punctuation token is held back until a
        # following real word actually agrees: committing one eagerly would
        # advance the committed frontier by its timestamp (which can span
        # seconds of not-yet-stable audio, leading OR interior) and
        # permanently swallow words whisper later recognizes there.
        # Trailing punctuation reaches the transcript on a later pass or at
        # finish().
        agreed: List[AsrWord] = []
        pending: List[AsrWord] = []  # punct awaiting a confirmed neighbor
        commit_ci = 0  # hyp index just past the last committed token
        pi = ci = 0
        while ci < len(hyp):
            if _norm(hyp[ci].word) == "":
                pending.append(hyp[ci])
                ci += 1
                continue
            if pi >= len(self._prev_hyp):
                break
            if _norm(self._prev_hyp[pi].word) == "":
                pi += 1  # stale punctuation in prev: skip, don't consume cur
                continue
            if _norm(self._prev_hyp[pi].word) == _norm(hyp[ci].word):
                agreed.extend(pending)
                pending.clear()
                agreed.append(hyp[ci])
                pi += 1
                ci += 1
                commit_ci = ci
            else:
                break
        self._prev_hyp = hyp[commit_ci:]
        text = self._commit(agreed)

        if agreed:
            self._trim_to_abs(agreed[-1].end - self.TRIM_MARGIN_S)
        elif len(self.audio_buffer) / SAMPLING_RATE > self.buffer_trimming_sec:
            # Safety valve: nothing agreed but the buffer keeps growing.
            self._trim_to_abs(self.buffer_time_offset
                              + len(self.audio_buffer) / SAMPLING_RATE
                              - self.buffer_trimming_sec)
        return text

    def _trim_to_abs(self, t_abs: float):
        """Drop buffer audio before absolute time t_abs."""
        rel = t_abs - self.buffer_time_offset
        if rel <= 0:
            return
        cut = min(int(rel * SAMPLING_RATE), len(self.audio_buffer))
        self.audio_buffer = self.audio_buffer[cut:]
        self.buffer_time_offset += cut / SAMPLING_RATE
        # keep only the tail of _prev_hyp that is still inside the buffer
        self._prev_hyp = [w for w in self._prev_hyp
                          if w.end > self.buffer_time_offset]
        self._absorb_scrolled_out()

    def finish(self) -> str:
        """Flush: commit the current best hypothesis (stt:245-254)."""
        if len(self.audio_buffer) < SAMPLING_RATE // 10:
            return ""
        hyp = self._drop_committed(self._hypothesis())
        text = self._commit(hyp)
        # The consumed audio is gone: advance the absolute-time offset so
        # the next utterance's words land *after* the committed frontier
        # (otherwise _drop_committed would swallow its opening words).
        self.buffer_time_offset += len(self.audio_buffer) / SAMPLING_RATE
        self.audio_buffer = np.zeros((0,), dtype=np.float32)
        self._prev_hyp = []
        self._since_last_process = 0.0
        self._absorb_scrolled_out()
        return text

"""Real-time voice-to-voice chat pipeline (port of
`csm_mlx_tpu/apps/voice_chat.py`).

Mic -> streaming STT -> LLM -> streaming CSM TTS -> speaker, with barge-in
interruption, cooldown gating, a rolling conversation-context window,
latency bookkeeping and graceful shutdown (the reference's
`run_streaming_csm_mlx.py`). An asyncio pipeline of three workers joined
by queues:

  [audio-in thread] -> audio_in_q -> vad_stt_worker -> stt_out_q
      -> llm_worker -> llm_out_q -> tts_worker -> audio-out bridge

Audio I/O and the LLM are pluggable backends (`AudioIO`, `LLMBackend`):
`SoundDeviceIO` needs the sounddevice package, `TransformersLLM` the
transformers package, `FasterWhisperASR` (apps/stt.py) faster-whisper;
each is imported where it is first used. `NullAudioIO` and any text
callable serve tests and batch use. The TTS runs the port's
`generation.stream_generate` on the card: every frame after the first one
replayed CUDA graph, on the `tts-gen` worker thread; its chunks reach the
event loop as CPU tensors and the context segments keep numpy audio.

Reference anchors: ConversationState (run_streaming_csm_mlx.py:111-226),
interruption fade (:163-205, :1010-1019), sentence splitting (:921-937),
garbage filter (:667-721), rolling 6-segment context (:102, :1060-1073),
cooldown (:1142-1146), latency threshold (:74-77).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import re
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Protocol

import numpy as np

logger = logging.getLogger(__name__)

LLM_RESPONSE_END = "<LLM_RESPONSE_END>"       # sentinel (reference :105)
MAX_CONTEXT_SEGMENTS = 6                       # rolling window (:102)
LATENCY_THRESHOLD = 7.0                        # acceptable response s (:77)
TTS_TIMEOUT_S = 30.0                           # per-segment timeout (:992)
LLM_STREAM_TIMEOUT_S = 30.0                    # stuck-LLM safety valve
COOLDOWN_S = 0.5                               # post-TTS mic cooldown (:1142)
FADE_CHUNKS = 10                               # barge-in fade-out (:170-205)
STT_SAMPLE_RATE = 16000
TTS_SAMPLE_RATE = 24000


# ---------------------------------------------------------------------------
# Pluggable backends
# ---------------------------------------------------------------------------


class AudioIO(Protocol):
    """Audio device abstraction (sounddevice in production).

    `flush_output` / `output_backlog` are optional (looked up with getattr):
    backends that buffer playback should drop pending audio on barge-in and
    report how many seconds are still queued so the pipeline can keep the
    mic gated until the speaker actually goes quiet."""

    def start(self, on_input: Callable[[np.ndarray], None]) -> None: ...
    def play(self, chunk: np.ndarray) -> None: ...
    def stop(self) -> None: ...
    def flush_output(self) -> None: ...
    def output_backlog(self) -> float: ...


class NullAudioIO:
    """Collects output audio; input is injected manually (tests/batch)."""

    def __init__(self):
        self.played: List[np.ndarray] = []
        self.flushes = 0
        self._on_input = None

    def start(self, on_input):
        self._on_input = on_input

    def feed(self, chunk: np.ndarray):
        if self._on_input:
            self._on_input(chunk)

    def play(self, chunk: np.ndarray):
        self.played.append(np.asarray(chunk))

    def flush_output(self):
        self.flushes += 1  # a sink has no backlog; count for tests

    def output_backlog(self) -> float:
        return 0.0

    def stop(self):
        pass


class SoundDeviceIO:
    """Real mic/speaker backend (requires the sounddevice package)."""

    def __init__(self, in_rate=STT_SAMPLE_RATE, out_rate=TTS_SAMPLE_RATE,
                 block_ms=50, input_device=None, output_device=None):
        import sounddevice as sd

        self._sd = sd
        self.in_rate = in_rate
        self.out_rate = out_rate
        self.block = int(in_rate * block_ms / 1000)
        self.input_device = input_device
        self.output_device = output_device
        self._in_stream = None
        self._out_stream = None
        self._out_buffer = np.zeros((0,), dtype=np.float32)
        self._lock = __import__("threading").Lock()

    def start(self, on_input):
        sd = self._sd

        def in_cb(indata, frames, t, status):
            on_input(indata[:, 0].copy())

        def out_cb(outdata, frames, t, status):
            with self._lock:
                take = min(frames, len(self._out_buffer))
                outdata[:take, 0] = self._out_buffer[:take]
                outdata[take:, 0] = 0.0
                self._out_buffer = self._out_buffer[take:]

        self._in_stream = sd.InputStream(
            samplerate=self.in_rate, channels=1, blocksize=self.block,
            callback=in_cb, device=self.input_device)
        self._out_stream = sd.OutputStream(
            samplerate=self.out_rate, channels=1, callback=out_cb,
            device=self.output_device)
        self._in_stream.start()
        self._out_stream.start()

    def play(self, chunk):
        with self._lock:
            self._out_buffer = np.append(self._out_buffer,
                                         np.asarray(chunk, dtype=np.float32))

    def flush_output(self):
        """Drop buffered (unplayed) audio — barge-in must actually silence
        the speaker, not just stop feeding it (reference :177 clears its
        output bridge queue on fade-out)."""
        with self._lock:
            self._out_buffer = np.zeros((0,), dtype=np.float32)

    def output_backlog(self) -> float:
        with self._lock:
            return len(self._out_buffer) / self.out_rate

    def stop(self):
        for s in (self._in_stream, self._out_stream):
            if s is not None:
                s.stop()
                s.close()


LLMBackend = Callable[[List[dict]], "str | Iterator[str]"]
"""messages [{role, content}] -> assistant reply.

Backends may return either a complete string (blocking) or an iterator of
text chunks (streaming, like the reference's mlx_lm token iterator at
run_streaming_csm_mlx.py:577-583); the llm worker handles both and emits
sentences to TTS incrementally as they complete."""


def echo_llm(messages: List[dict]) -> str:
    """Fallback LLM: repeat the user (for tests / wiring checks)."""
    user = [m for m in messages if m["role"] == "user"]
    return f"You said: {user[-1]['content']}" if user else "Hello!"


class TransformersLLM:
    """Streaming chat backend over any local HF causal LM (in place of the
    reference's mlx_lm Phi-3 default, :777-827).

    Runs `model.generate` in a worker thread with a TextIteratorStreamer and
    yields text chunks as they decode. Construct from a local model path
    (`TransformersLLM("/path/to/model")`) or from already-loaded
    (model, tokenizer) objects.
    """

    def __init__(self, model_or_path, tokenizer=None, max_tokens: int = 256,
                 temperature: float = 0.7, device: str = "cpu"):
        if isinstance(model_or_path, str):
            from transformers import AutoModelForCausalLM, AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(model_or_path)
            self.model = AutoModelForCausalLM.from_pretrained(
                model_or_path).to(device).eval()
        else:
            self.model = model_or_path
            self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.device = device

    def _prompt(self, messages: List[dict]) -> str:
        tok = self.tokenizer
        if getattr(tok, "chat_template", None):
            return tok.apply_chat_template(messages, tokenize=False,
                                           add_generation_prompt=True)
        lines = [f"{m['role']}: {m['content']}" for m in messages]
        return "\n".join(lines) + "\nassistant:"

    def __call__(self, messages: List[dict]):
        import threading

        import torch
        from transformers import TextIteratorStreamer

        inputs = self.tokenizer(self._prompt(messages), return_tensors="pt")
        inputs.pop("token_type_ids", None)  # fast tokenizers emit it; LMs don't take it
        # inputs must live on the model's device (generate raises otherwise);
        # derive from the parameters — callers may pass a pre-placed model
        try:
            device = next(self.model.parameters()).device
            inputs = {k: v.to(device) for k, v in inputs.items()}
        except StopIteration:  # parameterless fake in tests
            inputs = dict(inputs)
        streamer = TextIteratorStreamer(self.tokenizer, skip_prompt=True,
                                        skip_special_tokens=True,
                                        timeout=LLM_STREAM_TIMEOUT_S)
        kwargs = dict(
            **inputs, streamer=streamer,
            max_new_tokens=self.max_tokens,
            do_sample=self.temperature > 0,
            pad_token_id=self.tokenizer.pad_token_id
            if self.tokenizer.pad_token_id is not None
            else self.tokenizer.eos_token_id,
        )
        if self.temperature > 0:
            kwargs["temperature"] = self.temperature

        def run():
            try:
                with torch.no_grad():
                    self.model.generate(**kwargs)
            except Exception:  # end the stream so consumers never hang
                logger.exception("LLM generation failed")
                streamer.end()

        threading.Thread(target=run, daemon=True).start()
        return streamer


# ---------------------------------------------------------------------------
# Text hygiene (reference :667-721, :627-664)
# ---------------------------------------------------------------------------

_CONTROL_TOKEN_RE = re.compile(r"<\|?[a-zA-Z_]+\|?>|\[/?INST\]|</?s>")
_SENTENCE_END_RE = re.compile(r"([.!?…][\"')\]]?)(\s+|$)")


def scrub_llm_text(text: str) -> str:
    return _CONTROL_TOKEN_RE.sub("", text).strip()


def is_likely_garbage(text: str) -> bool:
    """Heuristic output filter (reference is_likely_garbage, :667-721)."""
    t = text.strip()
    if not t:
        return True
    if len(t) < 2:
        return True
    # isalnum, not isalpha: "42" is a perfectly good utterance (the
    # reference filter counts alphanumerics, run_streaming_csm_mlx.py:667+)
    alnum = sum(c.isalnum() or c.isspace() for c in t)
    if alnum / len(t) < 0.5:
        return True
    words = t.split()
    if len(words) >= 6:
        uniq = len(set(w.lower() for w in words))
        if uniq / len(words) < 0.34:  # heavy repetition
            return True
    return False


def split_sentences(text: str) -> List[str]:
    """Sentence-boundary split for incremental TTS (reference :921-937)."""
    out, pos = [], 0
    for m in _SENTENCE_END_RE.finditer(text):
        out.append(text[pos : m.end(1)].strip())
        pos = m.end()
    rest = text[pos:].strip()
    if rest:
        out.append(rest)
    return [s for s in out if s]


# ---------------------------------------------------------------------------
# Conversation state (reference :111-226)
# ---------------------------------------------------------------------------


@dataclass
class ConversationState:
    audio_in_q: asyncio.Queue = field(default_factory=asyncio.Queue)
    stt_out_q: asyncio.Queue = field(default_factory=asyncio.Queue)
    llm_out_q: asyncio.Queue = field(default_factory=asyncio.Queue)
    interruption: asyncio.Event = field(default_factory=asyncio.Event)
    shutdown: asyncio.Event = field(default_factory=asyncio.Event)
    tts_speaking: bool = False
    cooldown_until: float = 0.0
    # Set after a barge-in whose response wasn't fully flushed: sentences
    # of the interrupted response that arrive later are discarded until
    # its LLM_RESPONSE_END shows up.
    discard_response: bool = False
    messages: List[dict] = field(default_factory=list)
    context_segments: List = field(default_factory=list)
    llm_start: float = 0.0
    dump_audio: Optional[List[np.ndarray]] = None  # set when dumping a wav

    def record_llm_start(self):
        self.llm_start = time.monotonic()

    def record_response_done(self):
        elapsed = time.monotonic() - self.llm_start
        if elapsed > LATENCY_THRESHOLD:
            logger.warning("Response latency %.1fs exceeded threshold %.1fs",
                           elapsed, LATENCY_THRESHOLD)
        return elapsed


# ---------------------------------------------------------------------------
# Workers
# ---------------------------------------------------------------------------


async def vad_stt_worker(state: ConversationState, stt, executor) -> None:
    """Drain mic audio; gate on tts_speaking/cooldown; commit utterances
    (reference :354-519)."""
    loop = asyncio.get_running_loop()
    silence_run = 0.0
    speech_seen = False
    preroll: deque = deque()  # silent-mic chunks, bounded to ~1 s
    preroll_len = 0
    while not state.shutdown.is_set():
        try:
            chunk = await asyncio.wait_for(state.audio_in_q.get(), timeout=0.25)
        except asyncio.TimeoutError:
            # No audio at all is silence too: accumulate the timeout so an
            # utterance whose source just stops sending (batch/NullAudioIO
            # feeds, a paused mic) still flushes — the in-band path clears
            # speech_seen the moment it crosses the threshold itself, so
            # without this the flush below was unreachable.
            if speech_seen:
                silence_run += 0.25
            if speech_seen and silence_run > 0.7:
                text = await loop.run_in_executor(executor, stt.finish)
                speech_seen = False
                silence_run = 0.0
                if text and not is_likely_garbage(text):
                    await state.stt_out_q.put(text)
            continue
        if chunk is None:
            break
        now = time.monotonic()
        if state.tts_speaking:
            # mic activity while speaking -> barge-in (reference :1010-1019)
            if float(np.abs(chunk).mean()) > 0.02:
                state.interruption.set()
            continue  # discard stale audio while TTS is speaking
        if now < state.cooldown_until:
            continue
        rms = float(np.sqrt(np.mean(np.square(chunk)))) if len(chunk) else 0.0
        if rms > 0.01:
            if not speech_seen:
                # Replay the bounded pre-roll so the utterance onset keeps
                # its leading context.
                for pre in preroll:
                    stt.insert_audio_chunk(pre)
                preroll.clear()
                preroll_len = 0
            speech_seen = True
            silence_run = 0.0
        else:
            silence_run += len(chunk) / STT_SAMPLE_RATE
        if not speech_seen:
            # Idle mic: never feed the STT buffer (it would grow without
            # bound — hours of silence is ~230 MB and an O(n^2) np.append
            # treadmill, then one giant whisper call at speech onset).
            # Keep only ~1 s of pre-roll for onset context.
            preroll.append(chunk)
            preroll_len += len(chunk)
            while preroll and preroll_len > STT_SAMPLE_RATE:
                preroll_len -= len(preroll.popleft())
            continue
        stt.insert_audio_chunk(chunk)
        if speech_seen:
            text = await loop.run_in_executor(executor, stt.process_iter)
            if text and not is_likely_garbage(text):
                await state.stt_out_q.put(text)
            if silence_run > 0.7:
                text = await loop.run_in_executor(executor, stt.finish)
                speech_seen = False
                if text and not is_likely_garbage(text):
                    await state.stt_out_q.put(text)


async def llm_worker(state: ConversationState, llm: LLMBackend,
                     executor) -> None:
    """Accumulate user text, call the LLM, emit sentences + END sentinel
    (reference :523-664)."""
    loop = asyncio.get_running_loop()
    pending: List[str] = []
    last_text_time = 0.0
    while not state.shutdown.is_set():
        try:
            text = await asyncio.wait_for(state.stt_out_q.get(), timeout=0.25)
        except asyncio.TimeoutError:
            # Flush mid-sentence accumulations only after a real pause —
            # a LocalAgreement STT commits word-by-word, and firing the LLM
            # on a half sentence wastes a turn.
            if not pending or time.monotonic() - last_text_time < 1.0:
                continue
            text = None
        if text is not None:
            pending.append(text)
            last_text_time = time.monotonic()
            # Accumulate until the transcript looks finished (sentence-end
            # punctuation, reference :552-560) or the pause flush above.
            joined = " ".join(pending).strip()
            if not _SENTENCE_END_RE.search(joined[-3:] + " "):
                continue
        user_text = " ".join(pending).strip()
        pending = []
        if not user_text:
            continue
        state.record_llm_start()
        state.messages.append({"role": "user", "content": user_text})
        try:
            result = await loop.run_in_executor(executor, llm,
                                                list(state.messages))
            emitted = await _stream_llm_reply(state, result, loop, executor)
        except Exception:
            # One failed LLM call (bad chat template, backend hiccup) must
            # not take down the pipeline — same policy as the TTS worker.
            logger.exception("LLM call failed; dropping this turn")
            emitted = []
        if emitted:
            state.messages.append({"role": "assistant",
                                   "content": " ".join(emitted)})
        else:
            state.messages.pop()  # nothing usable came back
        await state.llm_out_q.put(LLM_RESPONSE_END)


# Behavior-defining stop strings (reference :571-575): generation ends at the
# chat end token; a role marker appearing mid-output means the model ran past
# its turn, so the reply truncates there. A *leading* chat header (e.g. the
# "<|assistant|>" a raw decode starts with) is stripped, not a stop.
_LLM_END_TOKEN = "<|eot_id|>"
_LLM_ROLE_MARKERS = ("user|>", "assistant|>", "<|end|>")
# Never strip stop tokens (eot_id/end): a reply that BEGINS with one is an
# empty turn and must stop there — deleting it as scaffolding would let
# run-past-turn text through to TTS.
_LEADING_HEADER_RE = re.compile(
    r"^\s*(?:<\|(?!eot_id\||end\|)[a-zA-Z_]+\|>\s*|</?s>\s*)+")


async def _stream_llm_reply(state: ConversationState, result, loop,
                            executor) -> List[str]:
    """Consume a blocking-str or streaming-iterator LLM reply, emitting
    scrubbed sentences to the TTS queue as soon as each one completes
    (incremental sentence-end detection over the token stream; reference
    :585-647 accumulates then splits — streaming the sentences out cuts
    time-to-first-audio by the remaining generation time)."""
    emitted: List[str] = []
    buf = ""
    done = False

    async def drain(final: bool) -> None:
        """Emit the scrubbed complete sentences at the head of the raw
        buffer; the (possibly mid-sentence, mid-control-token) tail stays
        buffered verbatim so chunk boundaries never eat characters."""
        nonlocal buf
        if final:
            head, buf = buf, ""
        else:
            last = None
            for m in _SENTENCE_END_RE.finditer(buf):
                last = m.end()
            if last is None:
                return
            head, buf = buf[:last], buf[last:]
        for s in split_sentences(scrub_llm_text(head)):
            if is_likely_garbage(s):
                logger.warning("Dropping garbage LLM sentence: %r", s[:80])
                continue
            emitted.append(s)
            await state.llm_out_q.put(s)

    if isinstance(result, str):
        chunks = iter([result])
    else:
        chunks = iter(result)

    started = False
    while not done and not state.shutdown.is_set():
        try:
            chunk = await asyncio.wait_for(
                loop.run_in_executor(executor, lambda: next(chunks, None)),
                timeout=LLM_STREAM_TIMEOUT_S,
            )
        except Exception as e:  # timeout / streamer Empty / backend error
            logger.warning("LLM stream ended abnormally (%s); flushing",
                           type(e).__name__)
            break
        if chunk is None:
            break
        buf += chunk.replace("\n\n", ". ")
        if not started:
            buf = _LEADING_HEADER_RE.sub("", buf)
            started = bool(buf.strip()) and not buf.lstrip().startswith("<")
        # stop markers (end token / run-past-turn role markers)
        cut = len(buf)
        for marker in (_LLM_END_TOKEN,) + _LLM_ROLE_MARKERS:
            pos = buf.find(marker)
            if pos != -1:
                cut = min(cut, pos)
        if cut < len(buf):
            buf = buf[:cut]
            done = True
        await drain(final=done)
    await drain(final=True)
    return emitted


async def tts_worker(state: ConversationState, tts_stream_fn, audio_io: AudioIO,
                     executor, speaker: int = 0) -> None:
    """Per-sentence streaming TTS with fade-out barge-in and rolling context
    (reference :875-1197).

    Generator calls run on a DEDICATED single-thread pool, not the shared
    executor: a wedged next() (the case TTS_TIMEOUT_S exists for) parks its
    thread forever, and on the shared 4-thread pool a few such timeouts
    would starve STT/LLM and freeze the whole pipeline. On a wedged
    timeout the pool is abandoned and replaced; only the stuck thread
    leaks."""
    loop = asyncio.get_running_loop()
    gen_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tts-gen")

    def abandon_pool() -> None:
        # Abandon the (possibly wedged) pool so the NEXT sentence gets a
        # live thread; a stuck thread inside it leaks by design.
        nonlocal gen_pool
        gen_pool.shutdown(wait=False)
        gen_pool = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="tts-gen")

    while not state.shutdown.is_set():
        try:
            sentence = await asyncio.wait_for(state.llm_out_q.get(), timeout=0.25)
        except asyncio.TimeoutError:
            continue
        if sentence == LLM_RESPONSE_END:
            if state.discard_response:
                # tail sentinel of an interrupted response — swallow it
                state.discard_response = False
                continue
            state.record_response_done()
            state.cooldown_until = time.monotonic() + COOLDOWN_S
            continue
        if state.discard_response:
            continue  # late sentence of an interrupted response

        state.tts_speaking = True
        state.interruption.clear()
        chunks: List[np.ndarray] = []
        t0 = time.monotonic()
        interrupted = False
        timed_out = False

        try:
            def generate():
                return tts_stream_fn(sentence, speaker,
                                     list(state.context_segments))

            gen = await loop.run_in_executor(gen_pool, generate)
            fade_remaining = -1
            while True:
                remaining = TTS_TIMEOUT_S - (time.monotonic() - t0)
                if remaining <= 0:
                    logger.warning("TTS generation timeout for segment")
                    timed_out = True
                    # No next() is in flight on this path, but close itself
                    # can block on a degraded device: run it on the OLD pool
                    # and hand the next sentence a fresh one, exactly like
                    # the wedged-next() branch below.
                    gen_pool.submit(gen.close)
                    abandon_pool()
                    break
                fut = loop.run_in_executor(gen_pool,
                                           lambda: next(gen, None))
                try:
                    # wait_for on a shield: threads can't be cancelled, but
                    # a wedged next() must not hang the worker forever
                    # (reference timeout semantics, :992-998).
                    chunk = await asyncio.wait_for(asyncio.shield(fut),
                                                   timeout=remaining)
                except asyncio.TimeoutError:
                    logger.warning("TTS generation timeout for segment")
                    timed_out = True
                    # Close the generator once the stuck next() returns —
                    # not safe while a next() is in flight. The asyncio
                    # done-callback runs on the EVENT LOOP thread, and
                    # close() may block on the same degraded device, so
                    # hand it to a throwaway daemon thread (rare path).
                    fut.add_done_callback(
                        lambda _f, g=gen: threading.Thread(
                            target=g.close, daemon=True).start())
                    abandon_pool()
                    break
                if chunk is None:
                    break
                chunk = np.asarray(chunk, dtype=np.float32).reshape(-1)
                if state.interruption.is_set() and fade_remaining < 0:
                    fade_remaining = FADE_CHUNKS
                    interrupted = True
                    # the card generates far faster than real time, so
                    # seconds of full-gain audio may already sit in the
                    # device buffer:
                    # drop it (reference :177) — the ramped chunks below
                    # provide the smooth stop.
                    flush = getattr(audio_io, "flush_output", None)
                    if flush is not None:
                        flush()
                if fade_remaining >= 0:
                    gain = max(fade_remaining / FADE_CHUNKS, 0.0)
                    ramp = np.linspace(gain,
                                       max(gain - 1.0 / FADE_CHUNKS, 0.0),
                                       len(chunk), dtype=np.float32)
                    chunk = chunk * ramp
                    fade_remaining -= 1
                audio_io.play(chunk)
                chunks.append(chunk)
                if state.dump_audio is not None:
                    state.dump_audio.append(chunk)
                if fade_remaining == 0:
                    break

            # Whether we stopped on fade-out or exhaustion: close the
            # generator so it releases its compiled-loop state instead of
            # idling half-consumed in the executor. Skipped on the wait_for
            # timeout path, where a next() is still in flight and the
            # done-callback above owns the close.
            if not timed_out:
                await loop.run_in_executor(gen_pool, gen.close)
        except Exception:
            # One bad sentence (e.g. context grown past the model window)
            # must not take down the whole pipeline — log and move on.
            logger.exception("TTS failed for segment; skipping")
        finally:
            # Generation outruns playback ~18x: keep the mic gated (and the
            # cooldown clock stopped) until the SPEAKER goes quiet, not just
            # until the last chunk was dispatched — otherwise the STT
            # worker transcribes the bot's own tail as user speech and
            # barge-in is dead for those seconds. A barge-in during the
            # drain still works: flush and bail.
            try:
                backlog = getattr(audio_io, "output_backlog", None)
                while (backlog is not None and backlog() > 0.05
                       and not state.shutdown.is_set()):
                    if state.interruption.is_set():
                        interrupted = True
                        flush = getattr(audio_io, "flush_output", None)
                        if flush is not None:
                            flush()
                        break
                    await asyncio.sleep(0.05)
            except Exception:
                pass
            state.tts_speaking = False
        state.cooldown_until = time.monotonic() + COOLDOWN_S
        if interrupted:
            # flush queued sentences from this response; if its END hasn't
            # arrived yet, discard stragglers as they come in
            state.discard_response = True
            while not state.llm_out_q.empty():
                item = state.llm_out_q.get_nowait()
                if item == LLM_RESPONSE_END:
                    state.discard_response = False
                    break
            state.interruption.clear()
            continue
        if chunks:
            from csm_mlx_tpu_torch.segment import Segment

            audio = np.concatenate(chunks)
            state.context_segments.append(Segment(speaker, sentence, audio))
            # rolling window (reference :1060-1073)
            del state.context_segments[:-MAX_CONTEXT_SEGMENTS]


# ---------------------------------------------------------------------------
# Pipeline wiring
# ---------------------------------------------------------------------------


class VoiceChatPipeline:
    """Owns the workers + threads; `run()` blocks until shutdown
    (reference main_async, :1200-1309)."""

    def __init__(self, stt, llm: LLMBackend, tts_stream_fn,
                 audio_io: Optional[AudioIO] = None, speaker: int = 0,
                 max_workers: int = 4, output_file: Optional[str] = None,
                 initial_context: Optional[List] = None):
        self.stt = stt
        self.llm = llm
        self.tts_stream_fn = tts_stream_fn
        self.audio_io = audio_io or NullAudioIO()
        self.speaker = speaker
        self.state = ConversationState()
        if initial_context:
            self.state.context_segments.extend(initial_context)
        self.output_file = output_file
        if output_file:
            self.state.dump_audio = []
        self.executor = ThreadPoolExecutor(max_workers=max_workers)

    async def run_async(self, duration: Optional[float] = None) -> None:
        state = self.state
        loop = asyncio.get_running_loop()

        def on_input(chunk: np.ndarray):
            loop.call_soon_threadsafe(state.audio_in_q.put_nowait, chunk)

        self.audio_io.start(on_input)
        tasks = [
            asyncio.create_task(vad_stt_worker(state, self.stt, self.executor)),
            asyncio.create_task(llm_worker(state, self.llm, self.executor)),
            asyncio.create_task(tts_worker(state, self.tts_stream_fn,
                                           self.audio_io, self.executor,
                                           self.speaker)),
        ]
        try:
            if duration is not None:
                await asyncio.sleep(duration)
                state.shutdown.set()
            await asyncio.gather(*tasks)
        finally:
            state.shutdown.set()
            for t in tasks:
                t.cancel()
            self.audio_io.stop()
            self.executor.shutdown(wait=False)
            self._dump_wav()

    def _dump_wav(self) -> None:
        """Save the session's generated audio (reference :1295-1307)."""
        if not (self.output_file and self.state.dump_audio):
            return
        from csm_mlx_tpu_torch.utils.audio import write_audio

        audio = np.concatenate(self.state.dump_audio)
        write_audio(audio, self.output_file, TTS_SAMPLE_RATE)
        logger.info("Saved %d samples of session audio to %s",
                    len(audio), self.output_file)

    def run(self, duration: Optional[float] = None) -> None:
        asyncio.run(self.run_async(duration))


def build_tts_stream_fn(model, **gen_kwargs):
    """Bind the port's `stream_generate` to a (text, speaker, context)
    call. Every call draws from one generator on the model's device (the
    caller's `generator=`, else one seeded once here), so that the frame
    step a sentence captures on the card is kept for the next sentence of
    the same prompt bucket instead of being built anew."""
    import torch

    from csm_mlx_tpu_torch.generation import stream_generate

    if gen_kwargs.get("generator") is None:
        generator = torch.Generator(device=model.device)
        generator.manual_seed(int(np.random.randint(0, 2 ** 31 - 1)))
        gen_kwargs["generator"] = generator

    def fn(text: str, speaker: int, context):
        return stream_generate(model, text, speaker, context, **gen_kwargs)

    return fn


def _build_parser() -> argparse.ArgumentParser:
    """Flag surface parity with run_streaming_csm_mlx.py:1312-1352."""
    parser = argparse.ArgumentParser(
        description="Real-time voice chat (mic -> STT -> LLM -> CSM TTS)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-i", "--input-device", type=int, default=None,
                        help="Input audio device id")
    parser.add_argument("-o", "--output-device", type=int, default=None,
                        help="Output audio device id")
    parser.add_argument("--output-file", type=str, default=None,
                        help="Save the session's generated audio as a WAV")
    parser.add_argument("--list-devices", action="store_true",
                        help="List audio devices and exit")
    parser.add_argument("--duration", type=float, default=None,
                        help="Stop after N seconds (default: run until ^C)")

    m = parser.add_argument_group("TTS model and quantization")
    m.add_argument("--model-repo", "--weight", dest="model_repo",
                   default="senstella/csm-1b-mlx",
                   help="Local weight file or directory (a hub repo id is "
                        "not fetched)")
    m.add_argument("--adapter-file", default=None)
    m.add_argument("--quantize", action="store_true")
    m.add_argument("--quantize-bits", type=int, default=4)
    m.add_argument("--quantize-group-size", type=int, default=64)
    m.add_argument("--quantize-mode", default="affine",
                   choices=["affine", "w8a8", "w4a8"],
                   help="'w8a8' runs the whole-frame decoder kernel, the "
                        "fastest decode path on the card")

    s = parser.add_argument_group("STT parameters")
    s.add_argument("--stt-model-size", "--whisper-model",
                   dest="stt_model_size", default="tiny.en")
    s.add_argument("--stt-device", default="cpu")
    s.add_argument("--stt-compute-type", default="int8")
    s.add_argument("--stt-lang", "--stt-language", dest="stt_lang",
                   default="en")
    s.add_argument("--online-min-chunk-seconds", type=float, default=0.2)

    g = parser.add_argument_group("TTS generation parameters")
    g.add_argument("-s", "--speaker", type=int, default=0)
    g.add_argument("-t", "--temperature", type=float, default=0.6)
    g.add_argument("-k", "--top-k", type=int, default=50)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--min-p", type=float, default=0.05)
    g.add_argument("--max-audio-length-ms", type=float, default=10_000)

    c = parser.add_argument_group("initial context (optional)")
    c.add_argument("--context-audio", type=str, nargs="*")
    c.add_argument("--context-text", type=str, nargs="*")
    c.add_argument("--context-speaker", type=str, nargs="*")

    l = parser.add_argument_group("LLM parameters")
    l.add_argument("--llm-model-path", type=str, default=None,
                   help="Local path / HF dir of a transformers causal LM; "
                        "omit for the echo backend")
    l.add_argument("--llm-max-tokens", type=int, default=256)
    l.add_argument("--llm-temp", type=float, default=0.7)
    return parser


def _load_context(args) -> List:
    """(--context-audio/-text/-speaker) -> Segments (reference :1202-1213)."""
    from csm_mlx_tpu_torch.segment import Segment

    audios = args.context_audio or []
    texts = args.context_text or []
    speakers = args.context_speaker or []
    if not (len(audios) == len(texts) == len(speakers)):
        raise SystemExit("--context-audio/-text/-speaker must have equal "
                         "lengths")
    return [Segment(int(spk), txt, audio_path=ap)
            for ap, txt, spk in zip(audios, texts, speakers)]


def main() -> None:
    args = _build_parser().parse_args()
    if args.list_devices:
        import sounddevice as sd

        print(sd.query_devices())
        return

    from csm_mlx_tpu_torch.cli.generate import parse_weight_argument
    from csm_mlx_tpu_torch.device import resolve_device
    from csm_mlx_tpu_torch.loaders import load_csm_weights
    from csm_mlx_tpu_torch.models.csm import CSM, csm_1b
    from csm_mlx_tpu_torch.ops.sampling import SamplerConfig

    weight = parse_weight_argument(args.model_repo)
    # the card unless there is none (resolve_device raises then)
    model = CSM(csm_1b(), params=load_csm_weights(
        weight, device=resolve_device()))
    if args.adapter_file:
        from csm_mlx_tpu_torch.finetune.lora import load_adapters

        load_adapters(model, args.adapter_file)
    if args.quantize:
        from csm_mlx_tpu_torch.ops.quant import quantize_model

        quantize_model(model, bits=args.quantize_bits,
                       group_size=args.quantize_group_size,
                       mode=args.quantize_mode)
    if model.device.type == "cuda":
        from csm_mlx_tpu_torch.ops import _build

        # the kernels' build (~20 s of nvcc) must not fall inside the
        # first sentence's TTS_TIMEOUT_S
        _build.library()

    from csm_mlx_tpu_torch.apps.stt import FasterWhisperASR, OnlineASRProcessor

    stt = OnlineASRProcessor(
        FasterWhisperASR(args.stt_model_size, language=args.stt_lang,
                         device=args.stt_device,
                         compute_type=args.stt_compute_type),
        min_chunk_seconds=args.online_min_chunk_seconds,
    )
    sampler = SamplerConfig(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, min_p=args.min_p)
    tts = build_tts_stream_fn(model, sampler=sampler,
                              max_audio_length_ms=args.max_audio_length_ms)
    llm: LLMBackend = echo_llm
    if args.llm_model_path:
        llm = TransformersLLM(args.llm_model_path,
                              max_tokens=args.llm_max_tokens,
                              temperature=args.llm_temp)
    audio_io = SoundDeviceIO(input_device=args.input_device,
                             output_device=args.output_device)
    VoiceChatPipeline(stt, llm, tts, audio_io, speaker=args.speaker,
                      output_file=args.output_file,
                      initial_context=_load_context(args)).run(args.duration)


if __name__ == "__main__":
    main()

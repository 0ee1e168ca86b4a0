"""The port's voice chat (`csm_mlx_tpu_torch/apps/voice_chat.py`,
`apps/stt.py`) against the JAX package's: the cases of
`tests/test_voice_chat.py` on the port's modules, with fake STT, LLM and
TTS backends (no audio device, no model download).

The text hygiene (`split_sentences`, `scrub_llm_text`,
`is_likely_garbage`) is held to JAX's functions on the same inputs, and
every `OnlineASRProcessor` case runs the same calls on the port's
processor and on JAX's (each with its own copy of the fake backend),
which must return the same text and keep the same committed words,
offsets and prompt after every call; the seeded fuzz of unstable tails
too. The pipeline cases (worker wiring, barge-in, cooldown, the TTS
timeout's fresh pool) run the port's workers.

Last, one session through `build_tts_stream_fn` on the tiny CSM on the
CPU (the port's `stream_generate`, greedy): a tiny codec over the real
SEANet ratios, so every chunk is 1,920 samples; each spoken sentence adds
one context segment, the window rolls at MAX_CONTEXT_SEGMENTS, and each
sentence's audio equals a direct `stream_generate` call on the context
the pipeline held when it spoke it."""

import asyncio
import dataclasses
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_args
from test_integration import FakeTextTokenizer
from test_mimi import TINY
from torch_helpers import torch_model_from_jax
from csm_mlx_tpu.apps import stt as jstt
from csm_mlx_tpu.apps import voice_chat as jvc
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu_torch import bridge
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch import tokenizers as ttok
from csm_mlx_tpu_torch.apps import stt
from csm_mlx_tpu_torch.apps import voice_chat as vc
from csm_mlx_tpu_torch.apps.stt import AsrSegment, AsrWord
from csm_mlx_tpu_torch.apps.voice_chat import (LLM_RESPONSE_END,
                                               MAX_CONTEXT_SEGMENTS,
                                               NullAudioIO,
                                               VoiceChatPipeline, echo_llm)
from csm_mlx_tpu_torch.models.mimi import Mimi as TMimi
from csm_mlx_tpu_torch.segment import Segment

# ---------------------------------------------------------------------------
# Text hygiene, against JAX's functions
# ---------------------------------------------------------------------------

SPLITS = [
    ("Hello there. How are you? Good!",
     ["Hello there.", "How are you?", "Good!"]),
    ("No terminal punctuation", ["No terminal punctuation"]),
    ("", []),
    ('He said "go." Then… left (quietly.) ok',
     ['He said "go."', "Then…", "left (quietly.)", "ok"]),
]
SCRUBS = [("<|assistant|>Hi there</s>", "Hi there"),
          ("[INST]x[/INST] ok", "x ok")]
GARBAGE = [("", True), ("###$$$%%%^^^&&&", True),
           ("a a a a a a a a a a a a", True),
           ("This is a perfectly normal sentence.", False),
           ("42.", False),  # digits are alnum
           ("It costs 1234 dollars.", False)]


def test_split_sentences():
    for text, want in SPLITS:
        assert vc.split_sentences(text) == jvc.split_sentences(text) == want


def test_scrub_llm_text():
    for text, want in SCRUBS:
        assert vc.scrub_llm_text(text) == jvc.scrub_llm_text(text) == want


def test_garbage_filter():
    for text, want in GARBAGE:
        assert vc.is_likely_garbage(text) == jvc.is_likely_garbage(text) \
            == want, text


# ---------------------------------------------------------------------------
# OnlineASRProcessor, the port's and JAX's side by side
# ---------------------------------------------------------------------------


class Twin:
    """The port's processor and JAX's, each over its own fake backend,
    driven by the same calls; every call returns the port's result after
    checking JAX's result and state equal to it. Attribute reads go to
    the port's processor."""

    def __init__(self, make_asr, **kw):
        object.__setattr__(self, "procs", (
            stt.OnlineASRProcessor(make_asr(), **kw),
            jstt.OnlineASRProcessor(make_asr(), **kw)))

    def __getattr__(self, name):
        return getattr(self.procs[0], name)

    def _both(self, name, *args):
        port, jax_ = self.procs
        got = getattr(port, name)(*args)
        want = getattr(jax_, name)(*args)
        assert got == want, (name, got, want)
        assert port.committed == jax_.committed
        assert port.buffer_time_offset == jax_.buffer_time_offset
        assert port.prompt_text == jax_.prompt_text
        assert np.array_equal(port.audio_buffer, jax_.audio_buffer)
        return got

    def insert_audio_chunk(self, audio):
        return self._both("insert_audio_chunk", audio)

    def process_iter(self):
        return self._both("process_iter")

    def finish(self):
        return self._both("finish")


class FakeASR:
    """Transcribes 1 'word' per second of audio, deterministic."""

    def transcribe(self, audio, init_prompt=""):
        seconds = int(len(audio) / 16000)
        return [AsrSegment(i, i + 1, f"word{i}") for i in range(seconds)]


class ScriptedHypASR:
    """Returns a scripted sequence of word-level hypotheses."""

    def __init__(self, hyps):
        self.hyps = list(hyps)
        self.i = 0

    def transcribe(self, audio, init_prompt=""):
        h = self.hyps[min(self.i, len(self.hyps) - 1)]
        self.i += 1
        return [AsrSegment(h[0][0], h[-1][1], " ".join(w for _, _, w in h),
                           words=[AsrWord(s, e, w) for s, e, w in h])]


def test_online_asr_local_agreement_commits_and_trims():
    proc = Twin(FakeASR)
    proc.insert_audio_chunk(np.zeros(16000 * 4, dtype=np.float32))
    assert proc.process_iter() == ""  # nothing to agree with yet
    text = proc.process_iter()
    assert "word0" in text and "word3" in text
    assert proc.buffer_time_offset > 0
    assert isinstance(proc.finish(), str)
    assert len(proc.audio_buffer) == 0


def test_online_asr_never_commits_revised_words():
    h1 = [(0.0, 0.4, "hello"), (0.4, 0.8, "wold")]
    h2 = [(0.0, 0.4, "hello"), (0.4, 0.8, "world"), (0.8, 1.2, "now")]
    proc = Twin(lambda: ScriptedHypASR([h1, h2, h2]))
    proc.insert_audio_chunk(np.zeros(16000 * 2, dtype=np.float32))
    assert proc.process_iter() == ""
    t2 = proc.process_iter()
    assert t2 == "hello"
    assert proc.process_iter() == "world now"
    assert "wold" not in " ".join(w for _, _, w in proc.committed)


def test_online_asr_second_utterance_after_finish():
    proc = Twin(FakeASR)
    proc.insert_audio_chunk(np.zeros(16000 * 4, dtype=np.float32))
    proc.process_iter()
    proc.process_iter()
    proc.finish()
    proc.insert_audio_chunk(np.zeros(16000 * 3, dtype=np.float32))
    assert proc.process_iter() == ""
    text = proc.process_iter()
    assert "word0" in text, f"opening words lost: {text!r}"


def test_online_asr_jitter_does_not_recommit():
    h1 = [(0.0, 1.0, "hello"), (1.0, 2.0, "world")]
    h2 = [(0.0, 1.05, "hello"), (1.05, 2.05, "world")]
    h3 = [(0.0, 1.05, "hello"), (1.05, 2.05, "world"), (2.05, 3.0, "again")]
    proc = Twin(lambda: ScriptedHypASR([h1, h1, h2, h3, h3]))
    proc.insert_audio_chunk(np.zeros(16000 * 3, dtype=np.float32))
    for _ in range(5):
        proc.process_iter()
    committed = [w for _, _, w in proc.committed]
    assert committed.count("world") == 1 and committed.count("hello") == 1
    assert "again" in committed


def test_online_asr_punctuation_token_does_not_stall():
    h = [(0.0, 0.4, "hello"), (0.4, 0.5, "..."), (0.5, 0.9, "world")]
    proc = Twin(lambda: ScriptedHypASR([h, h]))
    proc.insert_audio_chunk(np.zeros(16000, dtype=np.float32))
    proc.process_iter()
    assert "world" in proc.process_iter()


def test_online_asr_leading_punctuation_does_not_shift_alignment():
    h1 = [(0.0, 0.4, "hello"), (0.4, 0.8, "world")]
    h2 = [(0.0, 0.1, ","), (0.1, 0.4, "hello"), (0.4, 0.8, "world")]
    proc = Twin(lambda: ScriptedHypASR([h1, h2]))
    proc.insert_audio_chunk(np.zeros(16000, dtype=np.float32))
    proc.process_iter()
    text = proc.process_iter()
    assert "hello" in text and "world" in text, text


def test_online_asr_stray_leading_punctuation_never_commits():
    class PunctFirstASR:
        def __init__(self):
            self.calls = 0

        def transcribe(self, audio, init_prompt=""):
            self.calls += 1
            if self.calls == 1:  # noise pass: just a stray '.'
                return [AsrSegment(2.9, 3.1, ".")]
            seconds = int(len(audio) / 16000)
            return [AsrSegment(i, i + 1, f"word{i}") for i in range(seconds)]

    proc = Twin(PunctFirstASR, min_chunk_seconds=0.0)
    proc.insert_audio_chunk(np.zeros(16000 * 4, dtype=np.float32))
    assert proc.process_iter() == "" and proc.committed == []
    proc.insert_audio_chunk(np.zeros(16000, dtype=np.float32))
    text = proc.process_iter()
    proc.insert_audio_chunk(np.zeros(16000, dtype=np.float32))
    text += " " + proc.process_iter()
    assert "word0" in text


def test_online_asr_prompt_only_from_scrolled_out_text():
    proc = Twin(FakeASR, min_chunk_seconds=0.0)
    proc.insert_audio_chunk(np.zeros(16000 * 3, dtype=np.float32))
    proc.process_iter()
    proc.insert_audio_chunk(np.zeros(16000 * 2, dtype=np.float32))
    proc.process_iter()
    assert proc.committed, "setup: nothing committed"
    for (_s, e, w) in proc.committed[:proc._prompted_upto]:
        assert e <= proc.buffer_time_offset
    for (_s, e, w) in proc.committed[proc._prompted_upto:]:
        assert w.strip() not in proc.prompt_text.split() or \
            e <= proc.buffer_time_offset


def test_online_asr_min_chunk_gating():
    proc = Twin(FakeASR, min_chunk_seconds=1.0)
    proc.insert_audio_chunk(np.zeros(16000, dtype=np.float32))
    assert proc.process_iter() == ""   # primes agreement
    assert proc.process_iter() == ""   # gated: no new audio
    proc.insert_audio_chunk(np.zeros(16000 * 2, dtype=np.float32))
    assert "word0" in proc.process_iter()


def test_online_asr_punct_disagreement_does_not_commit():
    h1 = [(0.0, 0.4, "hello")]
    h2 = [(0.0, 2.0, ","), (2.0, 2.4, "goodbye")]
    proc = Twin(lambda: ScriptedHypASR([h1, h2, h2]))
    proc.insert_audio_chunk(np.zeros(16000 * 3, dtype=np.float32))
    assert proc.process_iter() == ""
    assert proc.process_iter() == ""
    assert "goodbye" in proc.process_iter()


def test_online_asr_interior_punct_disagreement_does_not_commit():
    h1 = [(0.0, 0.4, "hello"), (0.4, 0.8, "goodbye")]
    h2 = [(0.0, 0.4, "hello"), (0.4, 3.0, ","), (3.0, 3.4, "world")]
    proc = Twin(lambda: ScriptedHypASR([h1, h2, h2]))
    proc.insert_audio_chunk(np.zeros(16000 * 4, dtype=np.float32))
    assert proc.process_iter() == ""
    assert proc.process_iter() == "hello"
    assert proc.committed[-1][1] == pytest.approx(0.4)
    assert "world" in proc.process_iter()


def test_online_asr_frontier_adjacent_trailing_punct_commits_at_finish():
    h = [(0.0, 0.40, "hello"), (0.39, 0.40, ".")]
    proc = Twin(lambda: ScriptedHypASR([h, h, h, h]))
    proc.insert_audio_chunk(np.zeros(16000, dtype=np.float32))
    assert proc.process_iter() == ""
    assert proc.process_iter() == "hello"
    assert proc.process_iter() == ""
    assert "." in proc.finish()
    assert [w for _, _, w in proc.committed] == ["hello", "."]


def test_online_asr_frontier_adjacent_punct_commits_with_next_word():
    h1 = [(0.0, 0.40, "hello"), (0.39, 0.40, ".")]
    h2 = h1 + [(0.8, 1.2, "world")]
    proc = Twin(lambda: ScriptedHypASR([h1, h1, h2, h2, h2]))
    proc.insert_audio_chunk(np.zeros(16000 * 2, dtype=np.float32))
    assert proc.process_iter() == ""
    assert proc.process_iter() == "hello"
    assert proc.process_iter() == ""
    t4 = proc.process_iter()
    assert "." in t4 and "world" in t4
    proc.process_iter()
    assert [w for _, _, w in proc.committed] == ["hello", ".", "world"]


def _fuzz_session(module, seed):
    """JAX's fuzz of unstable tails on `module`'s processor: (the words
    each call returned, the committed record)."""
    rng = np.random.RandomState(200 + seed)
    rate, word_s = 16000, 0.4
    truth = [f"word{i}" for i in range(14)]
    corrupt, passes = {"on": True}, {"n": 0}

    class UnstableASR:
        def transcribe(self, audio, init_prompt=""):
            passes["n"] += 1
            offset = proc.buffer_time_offset
            span = len(audio) / rate
            words = []
            for i, w in enumerate(truth):
                s, e = i * word_s, (i + 1) * word_s
                if s >= offset - 1e-6 and e <= offset + span + 1e-6:
                    words.append([s - offset, e - offset, w])
            if corrupt["on"] and words:
                for j in range(int(rng.randint(0, 3))):
                    if j < len(words):
                        words[-1 - j][2] = f"bad{passes['n']}_{j}"
            if not words:
                return []
            return [module.AsrSegment(
                words[0][0], words[-1][1], " ".join(w for _, _, w in words),
                words=[module.AsrWord(s, e, w) for s, e, w in words])]

    proc = module.OnlineASRProcessor(UnstableASR(), buffer_trimming_sec=3.0)
    stream = []
    for _ in range(len(truth)):
        proc.insert_audio_chunk(np.zeros(int(rate * word_s), np.float32))
        stream.extend(proc.process_iter().split())
    corrupt["on"] = False
    for _ in range(3):
        stream.extend(proc.process_iter().split())
    stream.extend(proc.finish().split())
    return stream, [w for _, _, w in proc.committed], truth


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_online_asr_fuzz_unstable_tail_never_commits(seed):
    """A hypothesis tail corrupted differently on every pass: the committed
    text never holds a corrupted word, never revises, and ends as the
    ground truth, in both packages alike."""
    stream, record, truth = _fuzz_session(stt, seed)
    assert (stream, record) == _fuzz_session(jstt, seed)[:2]
    assert not any(w.startswith("bad") for w in stream), stream
    assert stream == truth and record == truth


def test_language_detection_sets_and_returns_language():
    class _Info:
        language = "fr"
        language_probability = 0.93

    class _FakeModel:
        def __init__(self):
            self.seen_len = None

        def transcribe(self, audio, **kw):
            self.seen_len = len(audio)
            return iter(()), _Info()

    asr = stt.FasterWhisperASR(language="en")
    fake = _FakeModel()
    asr._model = fake  # bypass the lazy faster-whisper load
    detected = asr.language_detection(
        np.zeros(stt.SAMPLING_RATE * 45, dtype=np.float32))
    assert detected == "fr" and asr.language == "fr"
    assert fake.seen_len == stt.SAMPLING_RATE * 30


# ---------------------------------------------------------------------------
# The pipeline with fakes
# ---------------------------------------------------------------------------


class ScriptedSTT:
    """Emits a scripted utterance once enough audio arrives."""

    def __init__(self, utterance="hello pipeline."):
        self.utterance = utterance
        self.total = 0
        self.emitted = False

    def insert_audio_chunk(self, chunk):
        self.total += len(chunk)

    def process_iter(self):
        if not self.emitted and self.total >= 16000:
            self.emitted = True
            return self.utterance
        return ""

    def finish(self):
        return ""


def fake_tts_stream(text, speaker, context):
    for _ in range(3):
        yield np.ones(1920, dtype=np.float32) * 0.1


def _feed_speech(audio_io, pipe, duration, n=8):
    async def scenario():
        run = asyncio.create_task(pipe.run_async(duration=duration))
        await asyncio.sleep(0.2)
        for _ in range(n):
            audio_io.feed(np.ones(4000, dtype=np.float32) * 0.2)
            await asyncio.sleep(0.02)
        await run

    asyncio.run(scenario())


def test_pipeline_end_to_end():
    audio_io = NullAudioIO()
    pipe = VoiceChatPipeline(ScriptedSTT("hi there."), echo_llm,
                             fake_tts_stream, audio_io)
    _feed_speech(audio_io, pipe, 3.0)
    assert len(audio_io.played) >= 3
    assert len(pipe.state.context_segments) >= 1
    assert pipe.state.messages[-1]["role"] == "assistant"
    assert "hi there." in pipe.state.messages[0]["content"]


def test_utterance_flushes_when_audio_source_stops():
    class FinishOnlySTT(ScriptedSTT):
        def __init__(self):
            super().__init__()
            self.finished = False

        def process_iter(self):
            return ""

        def finish(self):
            self.finished = True
            return "spoken at the end."

    stt_ = FinishOnlySTT()
    audio_io = NullAudioIO()
    pipe = VoiceChatPipeline(stt_, echo_llm, fake_tts_stream, audio_io)
    _feed_speech(audio_io, pipe, 3.0, n=4)
    assert stt_.finished, "finish() never ran after the source stopped"
    assert any(m["role"] == "user" and "spoken at the end." in m["content"]
               for m in pipe.state.messages)


def test_context_window_rolls():
    pipe = VoiceChatPipeline(ScriptedSTT(), echo_llm, fake_tts_stream,
                             NullAudioIO())
    for i in range(10):
        pipe.state.context_segments.append(
            Segment(0, f"s{i}", np.zeros(10, dtype=np.float32)))
        del pipe.state.context_segments[:-MAX_CONTEXT_SEGMENTS]
    assert len(pipe.state.context_segments) == MAX_CONTEXT_SEGMENTS
    assert pipe.state.context_segments[0].text == "s4"


def _stream_reply(result):
    state = vc.ConversationState()

    async def scenario():
        loop = asyncio.get_running_loop()
        with ThreadPoolExecutor(2) as ex:
            return await vc._stream_llm_reply(state, result, loop, ex)

    return state, asyncio.run(scenario())


def test_streaming_llm_sentences_emitted_incrementally():
    seen_at_third_chunk = []
    box = {}

    def chunks():
        yield "Hello wor"
        yield "ld. This is"
        seen_at_third_chunk.append(box["state"].llm_out_q.qsize())
        yield " more. <|eot_id|> trailing junk"

    state = vc.ConversationState()
    box["state"] = state

    async def scenario():
        loop = asyncio.get_running_loop()
        with ThreadPoolExecutor(2) as ex:
            return await vc._stream_llm_reply(state, chunks(), loop, ex)

    emitted = asyncio.run(scenario())
    assert emitted == ["Hello world.", "This is more."]
    assert seen_at_third_chunk == [1]
    q = []
    while not state.llm_out_q.empty():
        q.append(state.llm_out_q.get_nowait())
    assert q == ["Hello world.", "This is more."]


def test_streaming_llm_role_marker_truncates():
    _, emitted = _stream_reply(iter(["Sure thing. user|> pretend user turn."]))
    assert emitted == ["Sure thing."]


def test_blocking_llm_backend_still_works():
    _, emitted = _stream_reply("<|assistant|>One. Two!</s>")
    assert emitted == ["One.", "Two!"]


def test_streaming_llm_leading_eot_stops_empty_turn():
    state, emitted = _stream_reply(iter([
        "<|eot_id|>", " Hallucinated next turn that must never be spoken."]))
    assert emitted == [] and state.llm_out_q.empty()


def _tiny_hf_llm():
    """A real (tiny, deterministic) transformers causal LM: a zero lm_head
    makes greedy pick token 0, whose vocabulary entry is a sentence."""
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import (LlamaConfig, LlamaForCausalLM,
                              PreTrainedTokenizerFast)

    sentence = "Nice to meet you friend."
    vocab = {sentence: 0, "<unk>": 1, "</s>": 2, "<pad>": 3}
    for i, w in enumerate(["hello", "there", "user", "assistant", ":"],
                          start=4):
        vocab[w] = i
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    hf_tok = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                                     eos_token="</s>", pad_token="<pad>")
    cfg = LlamaConfig(vocab_size=len(vocab), hidden_size=32,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=2, intermediate_size=64,
                      max_position_embeddings=128, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg).eval()
    with torch.no_grad():
        model.lm_head.weight.zero_()
    return model, hf_tok, sentence


def test_e2e_real_tiny_lm_drives_stt_llm_tts():
    """STT -> a real (tiny) transformers LM, streaming -> TTS, fakes only at
    the audio edges; the session audio is written to a WAV through the
    port's `write_audio`."""
    model, tok, sentence = _tiny_hf_llm()
    llm = vc.TransformersLLM(model, tok, max_tokens=1, temperature=0.0)
    audio_io = NullAudioIO()
    with tempfile.TemporaryDirectory() as td:
        wav_path = os.path.join(td, "session.wav")
        pipe = VoiceChatPipeline(ScriptedSTT("hello there."), llm,
                                 fake_tts_stream, audio_io,
                                 output_file=wav_path)
        _feed_speech(audio_io, pipe, 4.0)
        assert pipe.state.messages[0]["content"] == "hello there."
        assert pipe.state.messages[-1]["role"] == "assistant"
        assert sentence in pipe.state.messages[-1]["content"]
        assert len(audio_io.played) >= 3
        from csm_mlx_tpu_torch.utils.audio import read_audio

        wav = read_audio(wav_path, 24000)
        assert len(wav) >= 3 * 1920


def test_barge_in_fades_and_flushes():
    audio_io = NullAudioIO()

    def long_tts(text, speaker, context):
        for _ in range(200):
            time.sleep(0.01)
            yield np.ones(1920, dtype=np.float32)

    pipe = VoiceChatPipeline(ScriptedSTT(), echo_llm, long_tts, audio_io)

    async def scenario():
        run = asyncio.create_task(pipe.run_async(duration=2.5))
        state = pipe.state
        await state.llm_out_q.put("first sentence.")
        await state.llm_out_q.put("queued sentence.")
        await state.llm_out_q.put(LLM_RESPONSE_END)
        deadline = time.monotonic() + 2.0
        while not state.tts_speaking and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        assert state.tts_speaking, "TTS never started"
        await asyncio.sleep(0.1)
        state.interruption.set()
        await run

    asyncio.run(scenario())
    assert audio_io.played, "TTS produced audio"
    assert audio_io.played[-1].max() < 1.0  # faded
    assert pipe.state.llm_out_q.empty()     # queued sentence flushed
    assert audio_io.flushes >= 1            # buffered audio dropped


def test_barge_in_discards_straggler_sentences():
    audio_io = NullAudioIO()
    spoken = []

    def tts(text, speaker, context):
        spoken.append(text)
        for _ in range(40):
            time.sleep(0.01)
            yield np.ones(1920, dtype=np.float32)

    pipe = VoiceChatPipeline(ScriptedSTT(), echo_llm, tts, audio_io)

    async def scenario():
        run = asyncio.create_task(pipe.run_async(duration=2.5))
        state = pipe.state
        await state.llm_out_q.put("first sentence.")
        deadline = time.monotonic() + 2.0
        while not state.tts_speaking and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        assert state.tts_speaking, "TTS never started"
        state.interruption.set()
        await asyncio.sleep(0.6)
        await state.llm_out_q.put("straggler sentence.")
        await state.llm_out_q.put(LLM_RESPONSE_END)
        await state.llm_out_q.put("next response.")
        await state.llm_out_q.put(LLM_RESPONSE_END)
        await run

    asyncio.run(scenario())
    assert "straggler sentence." not in spoken, spoken
    assert "next response." in spoken, spoken


def test_vad_stt_idle_mic_buffer_bounded():
    stt_ = ScriptedSTT("late hello.")
    state = vc.ConversationState()

    async def scenario():
        with ThreadPoolExecutor(2) as ex:
            task = asyncio.create_task(vc.vad_stt_worker(state, stt_, ex))
            for _ in range(60):
                state.audio_in_q.put_nowait(np.zeros(800, dtype=np.float32))
            await asyncio.sleep(0.3)
            silent_total = stt_.total
            for _ in range(25):
                state.audio_in_q.put_nowait(
                    np.ones(800, dtype=np.float32) * 0.2)
            await asyncio.sleep(0.3)
            state.shutdown.set()
            await task
            return silent_total

    assert asyncio.run(scenario()) == 0, "silent chunks reached the STT"
    assert 20000 <= stt_.total <= 16000 + 25 * 800
    assert stt_.emitted


def test_tts_timeout_does_not_starve_the_next_sentence(monkeypatch):
    monkeypatch.setattr(vc, "TTS_TIMEOUT_S", 0.4)
    unwedge = threading.Event()
    calls = []

    def tts_stream(text, speaker, context):
        calls.append(text)
        if len(calls) == 1:
            unwedge.wait()  # a wedged device call, released at teardown
            return
            yield  # pragma: no cover (makes this a generator)
        for _ in range(3):
            yield np.ones(1920, dtype=np.float32) * 0.1

    audio_io = NullAudioIO()
    state = vc.ConversationState()

    async def scenario():
        with ThreadPoolExecutor(2) as ex:
            task = asyncio.create_task(
                vc.tts_worker(state, tts_stream, audio_io, ex))
            await state.llm_out_q.put("first sentence wedges.")
            await state.llm_out_q.put("second sentence speaks.")
            await state.llm_out_q.put(LLM_RESPONSE_END)
            for _ in range(100):
                if len(audio_io.played) >= 3:
                    break
                await asyncio.sleep(0.1)
            state.shutdown.set()
            await task

    try:
        asyncio.run(scenario())
    finally:
        unwedge.set()
    assert calls == ["first sentence wedges.", "second sentence speaks."]
    assert len(audio_io.played) >= 3, "second sentence never played"


def test_flags_and_defaults_equal_jax():
    """The command line of `python -m csm_mlx_tpu_torch.apps.voice_chat`
    is JAX's: the same flags, destinations and defaults; so are the
    pipeline's constants."""
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default)
                for a in parser._actions if a.dest != "help"}

    assert flags(vc._build_parser()) == flags(jvc._build_parser())
    for name in ("LLM_RESPONSE_END", "MAX_CONTEXT_SEGMENTS",
                 "LATENCY_THRESHOLD", "TTS_TIMEOUT_S", "LLM_STREAM_TIMEOUT_S",
                 "COOLDOWN_S", "FADE_CHUNKS", "STT_SAMPLE_RATE",
                 "TTS_SAMPLE_RATE"):
        assert getattr(vc, name) == getattr(jvc, name), name


def test_main_reads_local_weights_onto_the_card(monkeypatch, tmp_path):
    """`main` takes a local weight file or directory (the default hub id
    exits naming the rule, as the port's other commands do) and loads
    CSM-1B onto the card: without one it raises `resolve_device`'s
    error before it reads the file."""
    monkeypatch.setattr("sys.argv", ["voice_chat"])
    with pytest.raises(SystemExit, match="not a local path"):
        vc.main()
    if torch.cuda.is_available():
        return
    (tmp_path / "ckpt.safetensors").write_bytes(b"")
    monkeypatch.setattr("sys.argv", ["voice_chat", "--weight", str(tmp_path)])
    with pytest.raises(RuntimeError, match="GPU|CUDA|cuda"):
        vc.main()


# ---------------------------------------------------------------------------
# A session on the tiny CSM through build_tts_stream_fn (CPU)
# ---------------------------------------------------------------------------

N_CB = 8
CODEC = dataclasses.replace(TINY, sampling_rate=24000, frame_rate=12.5,
                            upsampling_ratios=(8, 6, 5, 4),
                            num_quantizers=N_CB)


class _Ids(list):
    @property
    def ids(self):
        return list(self)


class FakeTokenizer(FakeTextTokenizer):
    def encode(self, text):
        return _Ids(super().encode(text))


@pytest.fixture(scope="module")
def tiny_tts():
    jm = jcsm.CSM(tiny_args(n_codebooks=N_CB), dtype=jnp.float32,
                  rng=jax.random.PRNGKey(61))
    jm.params["audio_head"] = jax.random.normal(
        jax.random.PRNGKey(62), jm.params["audio_head"].shape) * 0.5
    mimi = TMimi(bridge.mimi_config_from(CODEC), device="cpu",
                 generator=torch.Generator().manual_seed(63))
    return torch_model_from_jax(jm), mimi


def test_session_on_tiny_csm_rolls_its_context(tiny_tts, monkeypatch):
    model, mimi = tiny_tts
    monkeypatch.setattr(ttok, "get_text_tokenizer",
                        lambda path=None: FakeTokenizer())
    tts = vc.build_tts_stream_fn(model, temperature=0.0, mimi=mimi,
                                 max_audio_length_ms=240)
    seen = []  # (sentence, the context the pipeline handed over)

    def recording_tts(text, speaker, context):
        seen.append((text, list(context)))
        return tts(text, speaker, context)

    sentences = [f"Sentence number {i}." for i in range(8)]
    audio_io = NullAudioIO()
    state = vc.ConversationState()

    async def scenario():
        with ThreadPoolExecutor(2) as ex:
            task = asyncio.create_task(
                vc.tts_worker(state, recording_tts, audio_io, ex))
            for s in sentences:
                await state.llm_out_q.put(s)
            await state.llm_out_q.put(LLM_RESPONSE_END)
            deadline = time.monotonic() + 240
            while len(seen) < len(sentences) or state.tts_speaking \
                    or not state.llm_out_q.empty():
                assert time.monotonic() < deadline, "session did not finish"
                await asyncio.sleep(0.05)
            state.shutdown.set()
            await task

    asyncio.run(scenario())
    assert [t for t, _ in seen] == sentences
    assert audio_io.played and all(c.shape == (1920,) for c in audio_io.played)
    assert [len(c) for _, c in seen] == [min(i, MAX_CONTEXT_SEGMENTS)
                                         for i in range(len(sentences))]
    segs = state.context_segments
    assert [s.text for s in segs] == sentences[-MAX_CONTEXT_SEGMENTS:]
    # each sentence's audio: a direct stream on the context it was given
    for (text, context), seg in zip(seen[-MAX_CONTEXT_SEGMENTS:], segs):
        want = torch.cat(list(tgen.stream_generate(
            model, text, 0, context, 240, temperature=0.0,
            mimi=mimi))).numpy()
        assert seg.audio.dtype == np.float32
        np.testing.assert_array_equal(seg.audio, want)
    # and what was played ends with the kept segments' audio, in order
    kept = np.concatenate([s.audio for s in segs])
    np.testing.assert_array_equal(
        np.concatenate(audio_io.played)[-len(kept):], kept)

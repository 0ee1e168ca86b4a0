"""The port's profiling hooks (`csm_mlx_tpu_torch/utils/profiling.py`) and
the spans the entry points record with them, on the CPU: `annotate` as a
context manager, a no-op with no profiler; `trace` writing a Chrome trace
with the span's name; the spans of `stream_generate` (with and without
context) and of `ContinuousEngine`, counted against what the calls did."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (registers the tiny Llama configs)
from conftest import tiny_args
from test_mimi import TINY as TINY_MIMI
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch import tokenizers as ttok
from csm_mlx_tpu_torch.bridge import mimi_config_from
from csm_mlx_tpu_torch.continuous import ContinuousEngine
from csm_mlx_tpu_torch.models.csm import CSM as TorchCSM
from csm_mlx_tpu_torch.models.csm import ModelArgs as TorchModelArgs
from csm_mlx_tpu_torch.models.mimi import Mimi as TMimi
from csm_mlx_tpu_torch.segment import Segment
from csm_mlx_tpu_torch.utils import profiling
from csm_mlx_tpu_torch.utils.profiling import annotate, trace


def test_annotate_contextmanager():
    with annotate("test-span"):
        pass


def test_annotate_without_a_profiler_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for _ in range(3):
        with annotate("quiet"):
            pass
    # the same shared no-op every time
    assert annotate("a") is annotate("b")


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        with annotate("smoke-span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "smoke-span" in names
    assert any("mm" in str(n) for n in names)
    # closed: spans are no-ops again
    assert annotate("after") is profiling._OFF


def _spans(logdir) -> list:
    """The spans (user annotations) of the one trace in `logdir`, by
    start."""
    (path,) = list(logdir.glob("*.pt.trace.json"))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"),
                  key=lambda e: e["ts"])


def _count(spans, prefix) -> dict:
    out: dict = {}
    for e in spans:
        if e["name"].startswith(prefix):
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


class _Ids(list):
    @property
    def ids(self):
        return list(self)


class _FakeTextTokenizer:
    def encode(self, text: str):
        return _Ids([1] + [3 + (ord(c) % 50) for c in text[:10]] + [2])


@pytest.fixture(scope="module")
def model():
    """The port's tiny CSM (fp32, 8 codebooks) with a random audio_head (a
    zero head makes every decoder codebook 0, so frames near EOS)."""
    a = tiny_args(n_codebooks=8)
    args = TorchModelArgs(a.backbone_name, a.decoder_name, a.n_text_vocab,
                          a.n_audio_vocab, a.n_audio_codebooks)
    m = TorchCSM(args, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(3)
    head = m.params["audio_head"]
    m.params["audio_head"] = torch.randn(head.shape, generator=gen) * 0.5
    return m


@pytest.fixture(scope="module")
def mimi():
    cfg = mimi_config_from(dataclasses.replace(TINY_MIMI, num_quantizers=8))
    return TMimi(cfg, dtype=torch.float32, device="cpu",
                 generator=torch.Generator().manual_seed(5))


@pytest.mark.parametrize("n_context", [0, 2])
def test_stream_generate_spans(model, mimi, monkeypatch, tmp_path,
                               n_context):
    """n chunks read, then the iterator closed: one assemble, prefill and
    first, n EOS reads, n chunk copies, n replays (each chunk leaves after
    the next frame's launch), one encode a context segment, and no
    `stream.*` span open while the caller holds a chunk."""
    monkeypatch.setattr(ttok, "get_text_tokenizer",
                        lambda path=None: _FakeTextTokenizer())
    rng = np.random.RandomState(0)
    context = [Segment(i % 2, f"context {i}",
                       rng.randn(mimi.frame_size * 3).astype(np.float32))
               for i in range(n_context)]
    n = 4
    held = []
    with trace(str(tmp_path)):
        it = tgen.stream_generate(model, "hello", 0, context,
                                  max_audio_length_ms=80 * 10,
                                  temperature=0.0, mimi=mimi)
        for chunk in it:
            with annotate("caller"):
                held.append(chunk)
            if len(held) == n:
                break
        it.close()
    spans = _spans(tmp_path)
    want = {"stream.assemble": 1, "stream.prefill": 1, "stream.first": 1,
            "stream.eos": n, "stream.chunk": n, "stream.replay": n}
    if n_context:
        want["stream.encode"] = n_context
    assert _count(spans, "stream.") == want
    assert len(held) == n
    (assemble,) = [e for e in spans if e["name"] == "stream.assemble"]
    for e in spans:
        if e["name"] == "stream.encode":
            assert assemble["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= assemble["ts"] + assemble["dur"]
    stream = [(e["ts"], e["ts"] + e["dur"]) for e in spans
              if e["name"].startswith("stream.")]
    for c in (e for e in spans if e["name"] == "caller"):
        for a, b in stream:
            assert b <= c["ts"] or a >= c["ts"] + c["dur"]


def _prompt(args, s, seed):
    rng = np.random.RandomState(seed)
    k = args.n_audio_codebooks + 1
    prompt = np.zeros((s, k), dtype=np.int32)
    prompt[:, -1] = rng.randint(3, 200, size=s)
    mask = np.zeros((s, k), dtype=np.int32)
    mask[:, -1] = 1
    return prompt, mask


def test_engine_spans(model, tmp_path):
    """As many `engine.block` spans as blocks, `engine.admit` as admission
    batches, an `engine.fetch_wait` inside every `engine.fetch`; queue
    waits stamped for every admission."""
    eng = ContinuousEngine(model, generator=torch.Generator().manual_seed(7),
                           n_slots=2, max_frames=6, max_prompt_bucket=32,
                           capacity_slack=16, codec=False, frames_per_step=3)
    for i in range(3):  # one more than the slots: one waits for a slot
        eng.submit_prompt(*_prompt(model.args, 5 + i, seed=i), max_frames=6)
    st = eng.stats
    steps, batches = st.steps, st.admit_batches
    with trace(str(tmp_path)):
        eng.run_until_idle()
    spans = _spans(tmp_path)
    count = _count(spans, "engine.")
    assert st.steps > steps and st.admit_batches - batches >= 2
    assert count["engine.block"] == st.steps - steps
    assert count["engine.admit"] == st.admit_batches - batches
    assert count["engine.take"] >= st.steps - steps
    fetches = [e for e in spans if e["name"] == "engine.fetch"]
    waits = [e for e in spans if e["name"] == "engine.fetch_wait"]
    assert fetches and len(waits) == len(fetches)
    for f in fetches:
        assert sum(f["ts"] <= w["ts"] and w["ts"] + w["dur"]
                   <= f["ts"] + f["dur"] for w in waits) == 1
    lat = st.first_chunk_latency_ms()
    assert len(st.submit_to_admit) == 3
    assert lat["queue_p99_ms"] >= lat["queue_p90_ms"] \
        >= lat["queue_p50_ms"] >= 0

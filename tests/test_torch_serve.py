"""PyTorch port: the TTS servers, their HTTP front end and the `serve` CLI
(`csm_mlx_tpu_torch/serve.py`, `cli/`), on the CPU.

The cases of `tests/test_serve.py` on the port's tiny model (fp32, T = 0):
coalescing, backpressure and 503, stop, the int16 transfer (within one
PCM16 step of the float path), the HTTP routes, streaming, the 4xx / 500
rules and `wav_bytes`. A fake text tokenizer stands in for the real one
and the codec singleton is a random-init Mimi, as there. Then the
watermark through both servers, and the CLI parser's flags and defaults
against the JAX package's `cli/serve.py`."""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_args
from torch_helpers import torch_model_from_jax
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch import tokenizers as ttok
from csm_mlx_tpu_torch import watermark as twm
from csm_mlx_tpu_torch.serve import (ContinuousTTSServer, ServerOverloaded,
                                     TTSServer, _Pending, serve_http,
                                     wav_bytes)


class _Ids(list):
    @property
    def ids(self):
        return list(self)


class FakeTextTokenizer:
    def encode(self, text: str):
        return _Ids([1] + [3 + (ord(c) % 50) for c in text[:10]] + [2])


@pytest.fixture()
def offline_tokenizers(monkeypatch):
    monkeypatch.setattr(ttok, "get_text_tokenizer",
                        lambda path=None: FakeTextTokenizer())
    monkeypatch.delenv(ttok.MIMI_WEIGHTS_ENV, raising=False)
    ttok.get_audio_tokenizer.cache_clear()
    yield
    ttok.get_audio_tokenizer.cache_clear()


@pytest.fixture(scope="module")
def model():
    return torch_model_from_jax(jcsm.CSM(tiny_args(n_codebooks=8),
                                         dtype=jnp.float32,
                                         rng=jax.random.PRNGKey(0)))


def _continuous(model, **kw):
    kw.setdefault("max_audio_length_ms", 400)
    return ContinuousTTSServer(model, n_slots=2, max_prompt_bucket=32,
                               temperature=0.0, **kw)


async def _request(port, raw: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(raw)
    await writer.drain()
    data = await reader.read()
    writer.close()
    return data


def _post(path, payload) -> bytes:
    body = json.dumps(payload).encode()
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: "
            f"{len(body)}\r\n\r\n".encode() + body)


def _get(path) -> bytes:
    return f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode()


def _dechunk(payload: bytes) -> list:
    chunks = []
    while payload:
        size_hex, _, payload = payload.partition(b"\r\n")
        size = int(size_hex, 16)
        if size == 0:
            break
        chunks.append(payload[:size])
        payload = payload[size + 2:]  # chunk data + CRLF
    return chunks


def test_concurrent_requests_batch_together(offline_tokenizers, model):
    async def main():
        server = TTSServer(model, max_batch=4, max_wait_ms=200,
                           max_audio_length_ms=400, temperature=0.0)
        rows = await asyncio.gather(*[
            server.synthesize(f"hello {i}", speaker=i % 2) for i in range(4)
        ])
        await server.stop()
        return server, rows

    server, rows = asyncio.run(main())
    assert len(rows) == 4
    for r in rows:
        assert isinstance(r, np.ndarray) and r.ndim == 1 and r.size > 0
    assert server.stats.requests == 4
    assert server.stats.batches < 4  # all four in the wait window
    assert max(server.stats.batch_sizes) >= 2
    assert server.stats.aggregate_rtf > 0


def test_max_pending_backpressure(offline_tokenizers, model):
    async def main():
        server = TTSServer(model, max_batch=2, max_wait_ms=50,
                           max_audio_length_ms=400, temperature=0.0,
                           max_pending=1)
        # a full queue with no batcher draining it
        server._task = asyncio.create_task(asyncio.sleep(3600))
        fut = asyncio.get_running_loop().create_future()
        await server._queue.put(_Pending("queued", 0, (), fut))
        with pytest.raises(ServerOverloaded, match="max_pending"):
            await server.synthesize("too much")
        server._queue.get_nowait()
        fut.cancel()
        server._task.cancel()
        server._task = None
        audio = await server.synthesize("ok now")
        await server.stop()
        return audio

    assert asyncio.run(main()).size > 0


def test_stop_fails_batch_held_by_batcher(offline_tokenizers, model):
    async def main():
        server = TTSServer(model, max_batch=4, max_wait_ms=60_000,
                           max_audio_length_ms=400, temperature=0.0)
        task = asyncio.create_task(server.synthesize("held"))
        for _ in range(20):
            await asyncio.sleep(0.01)
            if server._queue.empty():
                break
        assert server._queue.empty(), "batcher never picked up the request"
        await asyncio.wait_for(server.stop(), timeout=5)
        with pytest.raises(RuntimeError, match="stopped"):
            await asyncio.wait_for(task, timeout=5)

    asyncio.run(main())


def test_int16_transfer_matches_float32(offline_tokenizers, model):
    async def run(transfer):
        server = TTSServer(model, max_batch=2, max_wait_ms=100,
                           max_audio_length_ms=400, temperature=0.0,
                           transfer=transfer)
        rows = await asyncio.gather(server.synthesize("hello a"),
                                    server.synthesize("hello b"))
        await server.stop()
        return rows

    f32 = asyncio.run(run("float32"))
    i16 = asyncio.run(run("int16"))
    for a, b in zip(f32, i16):
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(np.clip(a, -1.0, 1.0), b,
                                   atol=1.01 / 32767.0)
    with pytest.raises(ValueError, match="transfer"):
        TTSServer(model, transfer="int8")


def test_same_text_is_deterministic_at_temp0(offline_tokenizers, model):
    async def main():
        server = TTSServer(model, max_batch=2, max_wait_ms=100,
                           max_audio_length_ms=400, temperature=0.0)
        a, b = await asyncio.gather(server.synthesize("same"),
                                    server.synthesize("same"))
        await server.stop()
        return a, b

    a, b = asyncio.run(main())
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_generation_error_propagates_to_caller(model, monkeypatch):
    """No text tokenizer: generate_batch raises, and the caller's future
    carries the error instead of hanging."""
    monkeypatch.delenv(ttok.TEXT_TOKENIZER_ENV, raising=False)
    ttok.get_text_tokenizer.cache_clear()

    async def main():
        server = TTSServer(model, max_wait_ms=10, max_audio_length_ms=400)
        try:
            with pytest.raises(Exception):
                await asyncio.wait_for(server.synthesize("boom"), timeout=30)
        finally:
            await server.stop()

    asyncio.run(main())


def test_http_front_end(offline_tokenizers, model):
    async def main():
        server = TTSServer(model, max_batch=4, max_wait_ms=100,
                           max_audio_length_ms=400, temperature=0.0)
        http = await serve_http(server, host="127.0.0.1", port=0)
        port = http.sockets[0].getsockname()[1]
        health = await _request(port, _get("/healthz"))
        wavs = await asyncio.gather(
            _request(port, _post("/tts", {"text": "a"})),
            _request(port, _post("/tts", {"text": "b", "speaker": 1})))
        bad = await _request(port, _post("/tts", {"nope": 1}))
        missing = await _request(port, _get("/nope"))
        stats_raw = await _request(port, _get("/stats"))
        http.close()
        await http.wait_closed()
        await server.stop()
        return health, wavs, bad, missing, stats_raw

    health, wavs, bad, missing, stats_raw = asyncio.run(main())
    assert health.startswith(b"HTTP/1.1 200") and health.endswith(b"ok")
    for w in wavs:
        assert w.startswith(b"HTTP/1.1 200")
        assert b"audio/wav" in w
        body = w.split(b"\r\n\r\n", 1)[1]
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    assert bad.startswith(b"HTTP/1.1 400")
    assert missing.startswith(b"HTTP/1.1 404")
    stats = json.loads(stats_raw.split(b"\r\n\r\n", 1)[1])
    assert stats["requests"] == 2


def test_stream_and_batch_share_device_without_deadlock(offline_tokenizers,
                                                        model):
    async def main():
        server = TTSServer(model, max_batch=2, max_wait_ms=50,
                           max_audio_length_ms=400, temperature=0.0)

        async def collect_stream():
            return [c async for c in server.synthesize_stream("stream me")]

        chunks, row = await asyncio.gather(collect_stream(),
                                           server.synthesize("batch me"))
        await server.stop()
        return server, chunks, row

    server, chunks, row = asyncio.run(main())
    assert len(chunks) >= 2
    for c in chunks:
        assert c.dtype == np.float32 and c.shape == (1920,)
    assert row.size > 0
    assert server.stats.requests == 2


def test_http_stream_endpoint(offline_tokenizers, model):
    async def main():
        server = TTSServer(model, max_wait_ms=10, max_audio_length_ms=400,
                           temperature=0.0)
        http = await serve_http(server, host="127.0.0.1", port=0)
        port = http.sockets[0].getsockname()[1]
        raw = await _request(port, _post("/tts-stream", {"text": "chunked"}))
        http.close()
        await http.wait_closed()
        await server.stop()
        return raw

    raw = asyncio.run(main())
    head, _, payload = raw.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200")
    assert b"Transfer-Encoding: chunked" in head
    assert b"audio/L16" in head
    sizes = [len(c) for c in _dechunk(payload)]
    assert len(sizes) >= 2
    assert all(s == 1920 * 2 for s in sizes)  # s16le, one 80 ms chunk each


def test_padded_bucket_clamps_to_max_batch(offline_tokenizers, model,
                                           monkeypatch):
    """A max_batch that is not a power of two pads a full batch to
    max_batch, never past it."""
    seen = []
    real = tgen.generate_batch

    def spy(model_, texts, *a, **kw):
        seen.append(len(texts))
        return real(model_, texts, *a, **kw)

    monkeypatch.setattr(tgen, "generate_batch", spy)

    async def main():
        server = TTSServer(model, max_batch=3, max_wait_ms=300,
                           max_audio_length_ms=400, temperature=0.0)
        rows = await asyncio.gather(*[
            server.synthesize(f"clamp {i}") for i in range(3)])
        await server.stop()
        return rows

    rows = asyncio.run(main())
    assert len(rows) == 3 and all(r.size > 0 for r in rows)
    assert 3 in seen and all(s <= 3 for s in seen)


def test_continuous_server_mixed_requests(offline_tokenizers, model):
    """Whole-utterance and streaming callers share the slot loop; more
    requests than slots recycle rows. Each waveform is its engine frames'
    chunks, 1,920 samples a frame."""
    async def main():
        server = _continuous(model)

        async def one_stream():
            return [c async for c in server.synthesize_stream("stream req")]

        results = await asyncio.gather(
            *[server.synthesize(f"cont {i}") for i in range(4)],
            one_stream())
        await server.stop()
        return server, results

    server, results = asyncio.run(main())
    waves, chunks = results[:4], results[4]
    for w in waves:
        assert isinstance(w, np.ndarray) and w.ndim == 1
        assert w.size > 0 and w.size % 1920 == 0
    assert len(chunks) >= 1 and all(c.shape == (1920,) for c in chunks)
    assert server.stats.requests == 5
    assert server.engine.stats.completed == 5
    assert server.engine.stats.admissions == 5


def test_continuous_server_http_front_end(offline_tokenizers, model):
    """serve_http takes the continuous server: /tts, and /tts-stream whose
    chunks joined are the /tts body of the same greedy request within one
    PCM16 step (a later request decodes in a recycled row of the codec's
    ring, at other absolute rotary positions)."""
    async def main():
        server = _continuous(model)
        http = await serve_http(server, host="127.0.0.1", port=0)
        port = http.sockets[0].getsockname()[1]
        wav = await _request(port, _post("/tts", {"text": "over http"}))
        stream = await _request(port, _post("/tts-stream",
                                            {"text": "over http"}))
        stats_raw = await _request(port, _get("/stats"))
        http.close()
        await http.wait_closed()
        await server.stop()
        return wav, stream, stats_raw

    wav, stream, stats_raw = asyncio.run(main())
    head, _, body = wav.partition(b"\r\n\r\n")
    assert b"200 OK" in head and body[:4] == b"RIFF"
    shead, _, spayload = stream.partition(b"\r\n\r\n")
    assert b"200 OK" in shead
    streamed = np.frombuffer(b"".join(_dechunk(spayload)), "<i2")
    whole = np.frombuffer(body[44:], "<i2")
    assert streamed.shape == whole.shape and whole.size > 0
    assert np.abs(streamed.astype(np.int32) - whole).max() <= 1
    engine = json.loads(stats_raw.split(b"\r\n\r\n", 1)[1])["engine"]
    assert engine["admissions"] == 2 and engine["admit_p50_ms"] is not None


def test_continuous_server_stats_report_queue_wait(offline_tokenizers,
                                                   model):
    """Five requests on two slots: three wait in the queue for a slot, so
    /stats reports the engine's queue wait (submit to admission) above 0,
    its percentiles in order."""
    async def main():
        server = _continuous(model)
        http = await serve_http(server, host="127.0.0.1", port=0)
        port = http.sockets[0].getsockname()[1]
        await asyncio.gather(*[server.synthesize(f"queued {i}")
                               for i in range(5)])
        stats_raw = await _request(port, _get("/stats"))
        http.close()
        await http.wait_closed()
        await server.stop()
        return stats_raw

    engine = json.loads(asyncio.run(main()).split(b"\r\n\r\n", 1)[1])[
        "engine"]
    assert engine["admissions"] == 5
    assert engine["queue_p90_ms"] > 0
    assert engine["queue_p99_ms"] >= engine["queue_p90_ms"] \
        >= engine["queue_p50_ms"] >= 0


def test_continuous_server_aggregate_rtf_is_audio_per_wall_second(
        offline_tokenizers, model):
    """Concurrent requests: `generate_seconds` is the wall time with a
    request in flight (at most the gather's wall, not the sum of the
    requests' latencies), so `aggregate_rtf` is the audio delivered over
    it; a stream that fails leaves the count of requests in flight at
    0."""
    import time

    async def main():
        server = _continuous(model)
        await server.start()

        async def one_stream():
            return [c async for c in server.synthesize_stream("stream")]

        t0 = time.monotonic()
        out = await asyncio.gather(
            *[server.synthesize(f"rtf {i}") for i in range(4)], one_stream())
        wall = time.monotonic() - t0
        await server.stop()
        return server, out, wall

    server, out, wall = asyncio.run(main())
    st = server.stats
    audio = sum(w.size for w in out[:4]) + sum(c.size for c in out[4])
    assert st.in_flight == 0 and st.requests == 5
    assert 0 < st.generate_seconds <= wall
    assert st.audio_seconds == pytest.approx(audio / 24_000)
    assert st.aggregate_rtf == pytest.approx(
        st.audio_seconds / st.generate_seconds)


def test_server_stats_flight_counts_overlap_once(monkeypatch):
    """Two requests over [0, 3] and [1, 2], then one over [5, 6]: three
    seconds with one in flight, the gap not counted."""
    from csm_mlx_tpu_torch import serve as tserve

    now = [0.0]
    monkeypatch.setattr(tserve.time, "monotonic", lambda: now[0])
    st = tserve.ServerStats()
    for t, d in ((0, 1), (1, 1), (2, -1), (3, -1), (5, 1), (6, -1)):
        now[0] = float(t)
        st.flight(d)
    assert st.in_flight == 0
    assert st.generate_seconds == pytest.approx(4.0)


def test_wav_bytes_layout():
    import struct

    audio = np.sin(np.linspace(0, 10, 2400)).astype(np.float32)
    data = wav_bytes(audio, 24000)
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    assert len(data) == 44 + 2 * audio.size
    assert struct.unpack("<I", data[24:28])[0] == 24000


def test_soak_concurrent_streams_and_batches(offline_tokenizers, model):
    """Interleaved streams and batches, one stream abandoned mid-flight:
    all complete, and the device lock is free at the end."""
    async def main():
        server = TTSServer(model, max_batch=4, max_wait_ms=20,
                           max_audio_length_ms=400, temperature=0.0)

        async def one_stream(abandon=False):
            chunks = 0
            agen = server.synthesize_stream("soak stream", speaker=0)
            async for _chunk in agen:
                chunks += 1
                if abandon:
                    await agen.aclose()  # a client disconnect
                    return -1
            return chunks

        results = await asyncio.gather(
            one_stream(abandon=True),
            *[server.synthesize(f"soak batch {i}") for i in range(6)],
            one_stream(),
            *[server.synthesize(f"soak batch {i + 6}") for i in range(3)],
            one_stream())
        await server.stop()
        assert not server._device_lock.locked()
        return server, results

    server, results = asyncio.run(main())
    streams = [r for r in results if isinstance(r, int)]
    waves = [r for r in results if isinstance(r, np.ndarray)]
    assert -1 in streams
    assert sum(1 for s in streams if s > 0) == 2
    assert len(waves) == 9 and all(w.size > 0 for w in waves)
    assert server.stats.requests >= 11


def test_stream_backpressure(offline_tokenizers, model):
    async def main():
        server = TTSServer(model, max_wait_ms=10, max_audio_length_ms=400,
                           temperature=0.0, max_pending=1)
        await server._device_lock.acquire()  # the first stream waits
        gen1 = server.synthesize_stream("waits for device")
        t1 = asyncio.ensure_future(gen1.__anext__())
        for _ in range(20):
            await asyncio.sleep(0)
            if server._streams_pending >= 1:
                break
        assert server._streams_pending == 1
        gen2 = server.synthesize_stream("too many")
        with pytest.raises(ServerOverloaded, match="max_pending"):
            await gen2.__anext__()
        server._device_lock.release()
        chunks = [await t1]
        async for c in gen1:
            chunks.append(c)
        await server.stop()
        return chunks

    chunks = asyncio.run(main())
    assert len(chunks) >= 2 and all(c.shape == (1920,) for c in chunks)


def test_continuous_stream_backpressure(offline_tokenizers, model):
    async def main():
        server = _continuous(model, max_pending=1)
        server._started = True  # the engine deliberately not driving
        server.engine.submit("parked in queue")
        assert server.engine.pending() == 1
        gen = server.synthesize_stream("too many")
        with pytest.raises(ServerOverloaded, match="max_pending"):
            await gen.__anext__()

    asyncio.run(main())


def test_http_stream_overload_returns_503(offline_tokenizers, model):
    async def main():
        server = _continuous(model, max_pending=0)
        http = await serve_http(server, host="127.0.0.1", port=0)
        port = http.sockets[0].getsockname()[1]
        raw = await _request(port, _post("/tts-stream", {"text": "over"}))
        http.close()
        await http.wait_closed()
        await server.stop()
        return raw

    raw = asyncio.run(main())
    assert raw.startswith(b"HTTP/1.1 503")
    assert b"Transfer-Encoding: chunked" not in raw


def test_http_stream_prestream_error_returns_500(model, monkeypatch):
    """A failure before the first chunk (no text tokenizer) answers 500,
    not a truncated chunked 200."""
    monkeypatch.delenv(ttok.TEXT_TOKENIZER_ENV, raising=False)
    ttok.get_text_tokenizer.cache_clear()

    async def main():
        server = TTSServer(model, max_wait_ms=10, max_audio_length_ms=400,
                           temperature=0.0)
        http = await serve_http(server, host="127.0.0.1", port=0)
        port = http.sockets[0].getsockname()[1]
        raw = await asyncio.wait_for(
            _request(port, _post("/tts-stream", {"text": "boom"})),
            timeout=60)
        http.close()
        await http.wait_closed()
        await server.stop()
        return raw

    assert asyncio.run(main()).startswith(b"HTTP/1.1 500")


def test_http_client_errors_get_4xx_not_500(offline_tokenizers, model):
    async def main():
        server = TTSServer(model, max_batch=2, max_wait_ms=50,
                           max_audio_length_ms=400, temperature=0.0)
        http = await serve_http(server, host="127.0.0.1", port=0)
        port = http.sockets[0].getsockname()[1]
        out = [await _request(port, r) for r in (
            _post("/tts", {"text": "hi", "speaker": "loud"}),
            _post("/tts", {"text": 123}),
            _post("/tts-stream", {"text": "x", "speaker": [1]}),
            b"POST /tts HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: 10000000000\r\n\r\n",
            b"POST /tts HTTP/1.1\r\nHost: x\r\nContent-Length: -5\r\n\r\n",
            b"POST /tts HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: banana\r\n\r\n",
            _post("/tts", {"text": "hi", "speaker": 1}))]
        http.close()
        await http.wait_closed()
        await server.stop()
        return out

    bad_speaker, bad_text, bad_stream, huge, negative, garbled, ok = \
        asyncio.run(main())
    for resp in (bad_speaker, bad_text, bad_stream):
        assert resp.startswith(b"HTTP/1.1 400"), resp[:60]
    assert huge.startswith(b"HTTP/1.1 413"), huge[:60]
    assert negative.startswith(b"HTTP/1.1 400"), negative[:60]
    assert garbled.startswith(b"HTTP/1.1 400"), garbled[:60]
    assert ok.startswith(b"HTTP/1.1 200"), ok[:60]


def test_continuous_server_rejects_codecless_engine(model):
    from csm_mlx_tpu_torch.continuous import ContinuousEngine

    eng = ContinuousEngine(model, n_slots=2, max_frames=4,
                           max_prompt_bucket=32, capacity_slack=8,
                           codec=False)
    with pytest.raises(ValueError, match="codec"):
        ContinuousTTSServer(model, engine=eng)


def test_servers_reject_mesh(model):
    """Both servers take mesh= (tests/test_torch_parallel_serve.py); the
    continuous one still refuses a mesh beside an engine it did not build,
    as in JAX (the mesh would be ignored)."""
    from csm_mlx_tpu_torch.continuous import ContinuousEngine

    eng = ContinuousEngine(model, n_slots=2, max_frames=4,
                           max_prompt_bucket=32, capacity_slack=8,
                           codec=False)
    with pytest.raises(ValueError, match="mesh"):
        ContinuousTTSServer(model, engine=eng, mesh=object())


def test_stream_producer_base_exception_does_not_hang(model, monkeypatch):
    class Boom(BaseException):
        pass

    def bad_stream(*a, **k):
        raise Boom("device gave up")

    monkeypatch.setattr(tgen, "stream_generate", bad_stream)

    async def main():
        server = TTSServer(model, max_audio_length_ms=400)
        try:
            agen = server.synthesize_stream("x")
            with pytest.raises(Boom):
                await asyncio.wait_for(agen.__anext__(), timeout=30)
            await asyncio.wait_for(server._device_lock.acquire(), timeout=10)
            server._device_lock.release()
        finally:
            await server.stop()

    asyncio.run(main())


@pytest.mark.parametrize("continuous", [False, True])
def test_servers_watermark_their_waveforms(offline_tokenizers, model,
                                           continuous, monkeypatch):
    """watermark_key marks every waveform a server returns, on the model's
    device (the audio handed over as a tensor there, or with `device=`
    set; an array alone would go to `cuda`): the mark of the key is
    detected with its payload, and the unmarked run differs."""
    real, where = twm.embed_watermark, []

    def spy(audio, key, *a, device=None, **kw):
        where.append(device if device is not None else
                     audio.device if isinstance(audio, torch.Tensor) else
                     None)
        return real(audio, key, *a, device=device, **kw)

    monkeypatch.setattr(twm, "embed_watermark", spy)

    async def run(key):
        server = (_continuous(model, watermark_key=key,
                              max_audio_length_ms=1200) if continuous else
                  TTSServer(model, max_batch=2, max_wait_ms=10,
                            max_audio_length_ms=1200, temperature=0.0,
                            watermark_key=key))
        audio = await server.synthesize("mark me")
        await server.stop()
        return audio

    marked, plain = asyncio.run(run(11)), asyncio.run(run(None))
    assert marked.shape == plain.shape and marked.size >= 4 * 1024
    assert where and all(w is not None and torch.device(w) == model.device
                         for w in where)
    res = twm.detect_watermark(marked, 11, device="cpu")
    assert bool(res.present) and bool(twm.check_payload(res, 11))
    assert not np.array_equal(marked, plain)


def _flags(parser):
    """{dest: (option strings, default, type, choices, action)} of a
    subcommand parser, help texts aside."""
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     type(a).__name__)
            for a in parser._actions if a.dest not in ("help", "func")}


def _serve_parser(module):
    import argparse

    root = argparse.ArgumentParser()
    sub = root.add_subparsers()
    module.add_parser(sub)
    return sub.choices["serve"]


def test_serve_cli_flags_and_defaults_equal_jax():
    from csm_mlx_tpu.cli import serve as jserve
    from csm_mlx_tpu_torch.cli import serve as tserve
    from csm_mlx_tpu_torch.cli.application import build_parser

    assert _flags(_serve_parser(tserve)) == _flags(_serve_parser(jserve))
    args = build_parser().parse_args([
        "serve", "--port", "9000", "--max-batch", "4", "--quantize",
        "--watermark-key", "7", "--continuous", "--slots", "8"])
    assert args.command == "serve" and args.port == 9000
    assert args.max_batch == 4 and args.quantize and args.continuous
    assert args.watermark_key == 7 and args.slots == 8
    assert args.func is tserve.run


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "data=0"], "mesh axis"),
    (["--quantize-codec"], "requires --continuous"),
    (["--weight", "org/repo"], "not a local path"),
    (["--weight", "/nonexistent/weights.safetensors"], "not a local path"),
])
def test_serve_cli_exits_before_loading(argv, match):
    from csm_mlx_tpu_torch.cli.application import build_parser

    args = build_parser().parse_args(["serve"] + argv)
    with pytest.raises(SystemExit, match=match):
        args.func(args)


def test_weight_and_adapter_arguments_take_local_paths(tmp_path):
    from csm_mlx_tpu_torch.cli.generate import (parse_adapter_argument,
                                                parse_weight_argument)

    (tmp_path / "ckpt.safetensors").write_bytes(b"")
    assert parse_weight_argument(str(tmp_path)) == str(
        tmp_path / "ckpt.safetensors")
    (tmp_path / "mlx-ckpt.safetensors").write_bytes(b"")  # the first name
    assert parse_weight_argument(str(tmp_path)).endswith(
        "mlx-ckpt.safetensors")
    assert parse_adapter_argument(None) is None
    with pytest.raises(SystemExit, match="adapter files"):
        parse_adapter_argument(str(tmp_path))
    (tmp_path / "adapter_config.json").write_text("{}")
    (tmp_path / "adapters.safetensors").write_bytes(b"")
    assert parse_adapter_argument(str(tmp_path)) == str(tmp_path.resolve())


def test_serve_cli_makes_the_server_its_flags_ask_for(offline_tokenizers,
                                                      model):
    """The CLI's server from its flags; the continuous one over a copy of
    the tiny model with a 1,024-position window (the CLI keeps the engine's
    512-row prompt bucket)."""
    import dataclasses

    from conftest import TINY_BACKBONE
    from csm_mlx_tpu_torch import bridge
    from csm_mlx_tpu_torch.cli.application import build_parser
    from csm_mlx_tpu_torch.cli.serve import make_server
    from csm_mlx_tpu_torch.models.csm import CSM

    bridge.register_llama_configs(backbone={"tiny_wide": dataclasses.replace(
        TINY_BACKBONE, max_position_embeddings=1024)})
    wide = CSM(dataclasses.replace(model.args, backbone_name="tiny_wide"),
               params=model.params, dtype=model.dtype)

    def make(*flags):
        return make_server(build_parser().parse_args(
            ["serve", "--max-audio-length", "400", *flags]), wide)

    lock = make("--max-batch", "4", "--watermark-key", "5", "--transfer",
                "float32", "--max-pending", "3", "--temperature", "0")
    assert isinstance(lock, TTSServer)
    assert (lock.max_batch, lock.watermark_key, lock.transfer,
            lock.max_pending, lock.temperature) == (4, 5, "float32", 3, 0.0)
    cont = make("--continuous", "--slots", "2", "--watermark-key", "6")
    assert isinstance(cont, ContinuousTTSServer)
    assert cont.engine.n_slots == 2 and cont.watermark_key == 6
    assert cont.engine.transfer == "int16" and cont.engine.max_frames == 5


def test_serve_cli_quantize_codec_reaches_the_engine(offline_tokenizers,
                                                     model):
    """`serve --continuous --quantize-codec`: the engine decodes through an
    int8 copy of the codec's decoder; the codec singleton stays fp32."""
    import dataclasses

    from conftest import TINY_BACKBONE
    from csm_mlx_tpu_torch import bridge
    from csm_mlx_tpu_torch.cli.application import build_parser
    from csm_mlx_tpu_torch.cli.serve import make_server
    from csm_mlx_tpu_torch.models.csm import CSM
    from csm_mlx_tpu_torch.models.mimi.quant import mimi_decoder_is_quantized

    bridge.register_llama_configs(backbone={"tiny_wide": dataclasses.replace(
        TINY_BACKBONE, max_position_embeddings=1024)})
    wide = CSM(dataclasses.replace(model.args, backbone_name="tiny_wide"),
               params=model.params, dtype=model.dtype)
    server = make_server(build_parser().parse_args(
        ["serve", "--max-audio-length", "400", "--continuous", "--slots",
         "2", "--quantize-codec"]), wide)
    assert mimi_decoder_is_quantized(server.engine._mimi.params)
    shared = ttok.get_audio_tokenizer(model.n_audio_codebooks, device="cpu")
    assert not mimi_decoder_is_quantized(shared.params)

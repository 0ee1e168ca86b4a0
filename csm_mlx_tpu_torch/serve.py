"""Text-to-speech servers and their HTTP front end (port of
`csm_mlx_tpu/serve.py`).

- `TTSServer` (lockstep) coalesces concurrent requests: its batcher takes
  the first waiting request, admits more until `max_batch` or
  `max_wait_ms`, then runs one `generate_batch` in a worker thread and
  resolves each caller's future. Sampling settings are the server's; text,
  speaker and context vary per request; each row stops at its own EOS.
  `synthesize_stream` serves `stream_generate`'s 80 ms chunks instead;
  streams and batches take the card in turn under one lock.
- `ContinuousTTSServer` has the same surface over the continuous engine
  (`continuous.ContinuousEngine`): every request is a slot of one
  always-running batch, recycled when its stream ends, and chunks leave
  per frame for every caller.
- With `mesh=` (after `parallel.shard_model`), one server a rank: rank 0
  serves, every other rank runs the server's `follow()`, entering the
  same device programs on rank 0's broadcasts.
- `serve_http` is a dependency-free HTTP/1.1 front end on asyncio streams:
  `POST /tts` {"text": ..., "speaker": 0} -> audio/wav, `POST /tts-stream`
  -> raw 24 kHz s16le PCM over chunked transfer encoding, one HTTP chunk a
  generated chunk, `GET /healthz` and `GET /stats`.

The HTTP helpers and `wav_bytes` are the JAX package's, copied.
"""

from __future__ import annotations

import asyncio
import collections
import io
import json
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from csm_mlx_tpu_torch.segment import SAMPLING_RATE


class ServerOverloaded(RuntimeError):
    """Raised by synthesize() when the pending queue is at max_pending; the
    HTTP layer answers 503 so that clients back off."""


def _mesh_generator(model, mesh) -> Optional[torch.Generator]:
    """Under a mesh, the server's generator on this rank: rank 0's random
    seed, broadcast (a collective: every rank builds its server at once),
    offset by the data coordinate so that data groups draw apart while the
    ranks of a model group draw alike. None without a mesh (the global
    generator, as before)."""
    if mesh is None:
        return None
    from csm_mlx_tpu_torch.parallel.mesh import axis_sizes, broadcast_object

    seed = broadcast_object(int(np.random.randint(0, 2 ** 31 - 1)))
    if axis_sizes(mesh).get("data", 1) > 1:
        seed += mesh.get_local_rank("data")
    return torch.Generator(device=model.device).manual_seed(seed)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


@dataclass
class _Pending:
    text: str
    speaker: int
    context: Sequence
    future: asyncio.Future


@dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    # bounded: a long-running server must not grow an unbounded history
    batch_sizes: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=256))
    # the lockstep server: seconds of its batches and streams on the device,
    # one at a time under its lock; the continuous server: wall seconds in
    # which at least one request was in flight (`flight`)
    generate_seconds: float = 0.0
    audio_seconds: float = 0.0
    in_flight: int = 0
    _since: float = 0.0

    @property
    def aggregate_rtf(self) -> float:
        """Audio seconds delivered per second of `generate_seconds`."""
        return self.audio_seconds / self.generate_seconds \
            if self.generate_seconds else 0.0

    def flight(self, delta: int) -> None:
        """A request enters (+1) or leaves (-1) the service: the wall time
        since the last entry or exit counts into `generate_seconds` if a
        request was in flight through it."""
        now = time.monotonic()
        if self.in_flight:
            self.generate_seconds += now - self._since
        self._since = now
        self.in_flight += delta


class TTSServer:
    """Coalesces concurrent TTS requests into batched generation.

    `max_batch` (default 64, kernel 3's rows a launch) only binds under
    load: light traffic still runs small batches after `max_wait_ms`.
    `transfer="int16"` converts the waveforms to 16-bit PCM on the card
    and moves that (half the bytes); callers still get float32, and the
    HTTP endpoints send 16-bit PCM anyway. `max_pending` bounds the queue:
    past it synthesize() raises ServerOverloaded (HTTP 503); None is
    unbounded.

    `mesh` (after `parallel.shard_model(model, mesh)`; one server a rank,
    each built with the same arguments): batches pad to a multiple of the
    "data" axis and run `generate_batch(mesh=...)`. Rank 0 serves; every
    other rank runs `follow()`, which enters the same `generate_batch` or
    `stream_generate` on rank 0's broadcast of each request, until rank 0
    stops its server. A stream then runs to its end on every rank, also
    when its consumer leaves early.
    """

    def __init__(
        self,
        model,
        *,
        max_batch: int = 64,
        max_wait_ms: float = 30.0,
        max_audio_length_ms: float = 30_000,
        temperature: float = 0.8,
        sampler: Optional[Any] = None,
        watermark_key: Optional[int] = None,
        mesh: Optional[Any] = None,
        transfer: str = "float32",
        max_pending: Optional[int] = None,
    ):
        if transfer not in ("float32", "int16"):
            raise ValueError(f"transfer must be float32|int16, got {transfer}")
        self.mesh = mesh
        self._generator = _mesh_generator(model, mesh)
        self.model = model
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_audio_length_ms = max_audio_length_ms
        self.temperature = temperature
        self.sampler = sampler
        self.watermark_key = watermark_key
        self.transfer = transfer
        self.max_pending = max_pending
        self.stats = ServerStats()
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        # one device program at a time: batches and streams interleave at
        # request granularity
        self._device_lock = asyncio.Lock()
        # up to two batches in flight: one on the card while the previous
        # one's waveforms come back to the host
        self._inflight: set = set()
        self.max_inflight = 2
        # streams waiting for the device lock (max_pending bounds them too)
        self._streams_pending = 0
        self._released = False  # rank 0 of a mesh told the followers to stop

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._batcher())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._inflight:
            await asyncio.gather(*list(self._inflight),
                                 return_exceptions=True)
        # callers still queued must never hang past a stop
        while not self._queue.empty():
            p = self._queue.get_nowait()
            if not p.future.done():
                p.future.set_exception(RuntimeError("TTS server stopped"))
        if self.mesh is not None and _rank() == 0 and not self._released:
            from csm_mlx_tpu_torch.parallel.mesh import broadcast_object

            # after the device programs in flight: the followers leave
            async with self._device_lock:
                self._released = True
                await asyncio.get_running_loop().run_in_executor(
                    None, broadcast_object, None)

    def _batch(self, texts, speakers, contexts) -> List[Any]:
        """One `generate_batch` with the server's settings (every rank of
        a mesh calls it alike)."""
        from csm_mlx_tpu_torch.generation import generate_batch

        return generate_batch(
            self.model, texts, speakers, contexts,
            max_audio_length_ms=self.max_audio_length_ms,
            watermark_key=self.watermark_key,
            temperature=self.temperature, sampler=self.sampler,
            generator=self._generator, mesh=self.mesh)

    def _stream(self, text, speaker, context):
        from csm_mlx_tpu_torch.generation import stream_generate

        return stream_generate(
            self.model, text, speaker, context,
            max_audio_length_ms=self.max_audio_length_ms,
            temperature=self.temperature, sampler=self.sampler,
            generator=self._generator)

    def follow(self) -> None:
        """Every rank of a mesh but 0: run the batches and streams rank 0
        broadcasts, until rank 0 stops its server."""
        from csm_mlx_tpu_torch.parallel.mesh import broadcast_object

        if self.mesh is None or _rank() == 0:
            raise RuntimeError("follow() is for the ranks of a mesh other "
                               "than 0; rank 0 serves")
        while True:
            cmd = broadcast_object(None)
            if cmd is None:
                return
            kind, args = cmd
            if kind == "batch":
                self._batch(*args)
            else:
                for _ in self._stream(*args):
                    pass

    def _lead(self, kind: str, *args) -> None:
        """Rank 0 of a mesh: send the followers the device program it
        enters next."""
        if self.mesh is not None:
            from csm_mlx_tpu_torch.parallel.mesh import broadcast_object

            broadcast_object((kind, args))

    async def synthesize(self, text: str, speaker: int = 0,
                         context: Sequence = ()) -> np.ndarray:
        """Enqueue one utterance; resolves to a float32 24 kHz waveform.
        Raises ServerOverloaded when max_pending requests already wait."""
        if self._task is None:
            await self.start()
        if self.max_pending is not None and \
                self._queue.qsize() >= self.max_pending:
            raise ServerOverloaded(
                f"{self._queue.qsize()} requests pending (max_pending="
                f"{self.max_pending})")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put(_Pending(text, speaker, tuple(context), fut))
        return await fut

    async def synthesize_stream(self, text: str, speaker: int = 0,
                                context: Sequence = ()):
        """Async iterator of 1,920-sample float32 chunks (80 ms each) from
        `stream_generate`: the latency path. No watermark here (the mark
        needs the whole utterance's STFT); a caller who needs it embeds it
        in the joined result. Raises ServerOverloaded when max_pending
        streams already wait for the card."""
        if self.max_pending is not None and \
                self._streams_pending >= self.max_pending:
            raise ServerOverloaded(
                f"{self._streams_pending} streams pending (max_pending="
                f"{self.max_pending})")

        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        done = object()
        stop = threading.Event()  # set when the consumer goes away

        def run() -> float:
            t0 = time.monotonic()
            try:
                self._lead("stream", text, speaker, context)
                for chunk in self._stream(text, speaker, context):
                    if stop.is_set():
                        if self.mesh is not None:
                            continue  # the followers run it to its end
                        break  # the client went away: no more frames
                    loop.call_soon_threadsafe(
                        q.put_nowait, chunk.float().numpy())
            except BaseException as exc:
                # BaseException too: else neither the error nor the
                # sentinel reaches the consumer
                loop.call_soon_threadsafe(q.put_nowait, exc)
            else:
                loop.call_soon_threadsafe(q.put_nowait, done)
            return time.monotonic() - t0

        # The lock covers generation, not consumption: chunks buffer in q,
        # so a slow reader does not hold the card. It is released by the
        # future's callback, also when this generator is closed early.
        self._streams_pending += 1
        try:
            await self._device_lock.acquire()
        finally:
            self._streams_pending -= 1
        released = False

        def _release(_fut) -> None:
            nonlocal released
            if not released:
                released = True
                self._device_lock.release()

        try:
            fut = loop.run_in_executor(None, run)
        except BaseException:
            _release(None)
            raise
        fut.add_done_callback(_release)

        try:
            n_samples = 0
            while True:
                item = await q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    await fut
                    raise item
                n_samples += item.shape[-1]
                yield item
            wall = await fut
            self.stats.requests += 1
            self.stats.generate_seconds += wall
            self.stats.audio_seconds += n_samples / SAMPLING_RATE
        finally:
            stop.set()

    async def _batcher(self) -> None:
        # `batch` outside the try: requests dequeued but not yet handed to
        # a _run_batch task are failed here on a stop
        batch: List[_Pending] = []
        try:
            while True:
                first = await self._queue.get()
                batch = [first]
                deadline = time.monotonic() + self.max_wait_ms / 1000.0
                while len(batch) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(
                            self._queue.get(), timeout=remaining))
                    except asyncio.TimeoutError:
                        break
                # hand the batch to its own task and admit the next one
                # while it runs (the device lock orders the programs)
                while len(self._inflight) >= self.max_inflight:
                    await asyncio.wait(self._inflight,
                                       return_when=asyncio.FIRST_COMPLETED)
                task = asyncio.create_task(self._run_batch(batch))
                batch = []
                self._inflight.add(task)
                task.add_done_callback(self._inflight.discard)
        except asyncio.CancelledError:
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(RuntimeError("TTS server stopped"))
            raise

    async def _run_batch(self, batch: List[_Pending]) -> None:
        texts = [p.text for p in batch]
        speakers = [p.speaker for p in batch]
        contexts = [p.context for p in batch]
        # pad to a power of two (repeating the last request; the extra
        # rows are dropped), at most max_batch, so a server keeps few
        # configurations of the captured frame step
        target = 1
        while target < len(texts):
            target *= 2
        target = min(target, self.max_batch)
        if self.mesh is not None:
            # rows shard over the data axis only when they divide it
            from csm_mlx_tpu_torch.parallel.mesh import axis_sizes

            data = axis_sizes(self.mesh).get("data", 1)
            target = -(-target // data) * data
        while len(texts) < target:
            texts.append(texts[-1])
            speakers.append(speakers[-1])
            contexts.append(contexts[-1])

        def run_device() -> Tuple[List[Any], float]:
            t0 = time.monotonic()
            self._lead("batch", texts, speakers, contexts)
            rows = self._batch(texts, speakers, contexts)[:len(batch)]
            if self.transfer == "int16":
                # 16-bit PCM on the card (after the watermark): half the
                # bytes to the host
                rows = [torch.clamp(torch.round(r * 32767.0), -32768.0,
                                    32767.0).to(torch.int16) for r in rows]
            if rows and rows[0].is_cuda:
                # the compute done, the rows still on the card: the copy to
                # the host runs outside the device lock
                torch.cuda.synchronize(rows[0].device)
            return rows, time.monotonic() - t0

        def fetch(rows_dev) -> List[np.ndarray]:
            out = []
            for r in rows_dev:
                a = r.cpu().numpy()
                if a.dtype == np.int16:
                    a = a.astype(np.float32) / 32767.0
                out.append(a.astype(np.float32, copy=False))
            return out

        try:
            async with self._device_lock:
                rows_dev, wall = await asyncio.get_running_loop() \
                    .run_in_executor(None, run_device)
            rows = await asyncio.get_running_loop().run_in_executor(
                None, fetch, rows_dev)
        except BaseException as exc:  # resolve every caller, never deadlock
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(
                        exc if isinstance(exc, Exception)
                        else RuntimeError("TTS server stopped"))
            if not isinstance(exc, Exception):
                raise  # a CancelledError still cancels
            return
        self.stats.requests += len(batch)
        self.stats.batches += 1
        self.stats.batch_sizes.append(len(batch))
        self.stats.generate_seconds += wall
        self.stats.audio_seconds += sum(r.shape[-1] for r in rows) \
            / SAMPLING_RATE
        for p, row in zip(batch, rows):
            if not p.future.done():
                p.future.set_result(row)


class ContinuousTTSServer:
    """The `TTSServer` surface (synthesize / synthesize_stream / start /
    stop / stats; `serve_http` takes either) over the continuous engine:
    every request is a slot of one always-running batched frame loop, a
    finished row is recycled at once, streams and whole-utterance requests
    share the card without a lock, and chunks leave per frame.

    `generate_seconds` accrues the wall time in which at least one request
    was in flight, so `aggregate_rtf` is audio seconds per wall second
    across the service; the scheduler's own counters are
    `self.engine.stats` (and `/stats`).
    `n_slots` defaults to 64, kernel 3's rows a launch; `transfer` to
    "int16", lossless for the PCM16 endpoints. `quantize_codec` decodes
    through an int8 copy of the codec's decoder. `mesh` builds the engine
    with it (`ContinuousEngine(mesh=...)`): rank 0 serves, every other
    rank runs `follow()`.
    """

    def __init__(
        self,
        model,
        *,
        n_slots: int = 64,
        max_audio_length_ms: float = 30_000,
        max_prompt_bucket: int = 512,
        temperature: float = 0.8,
        sampler: Optional[Any] = None,
        watermark_key: Optional[int] = None,
        engine: Optional[Any] = None,
        max_pending: Optional[int] = None,
        transfer: str = "int16",
        quantize_codec: bool = False,
        mesh: Optional[Any] = None,
    ):
        from csm_mlx_tpu_torch.continuous import ContinuousEngine
        from csm_mlx_tpu_torch.generation import FRAME_MS

        if engine is not None and mesh is not None:
            raise ValueError(
                "pass mesh= to the ContinuousEngine constructor, not to "
                "ContinuousTTSServer(engine=<existing>, mesh=...)")
        max_frames = int(max_audio_length_ms / FRAME_MS)
        self.model = model
        self.max_audio_length_ms = max_audio_length_ms
        self.watermark_key = watermark_key
        self.max_pending = max_pending
        self.engine = engine or ContinuousEngine(
            model, n_slots=n_slots, max_frames=max_frames,
            max_prompt_bucket=max_prompt_bucket, temperature=temperature,
            sampler=sampler, codec=True, transfer=transfer,
            quantize_codec=quantize_codec, mesh=mesh)
        if not getattr(self.engine, "has_codec", False):
            # a codec-less engine would answer every request with no audio
            raise ValueError(
                "ContinuousTTSServer needs an engine running with a codec "
                "(ContinuousEngine(..., codec=True))")
        self.stats = ServerStats()
        self._started = False

    async def start(self) -> None:
        self.engine.start()
        self._started = True

    async def stop(self) -> None:
        self.engine.stop()
        self._started = False

    def follow(self) -> None:
        """Every rank of a mesh but 0: the engine's `follow()`."""
        self.engine.follow()

    async def synthesize(self, text: str, speaker: int = 0,
                         context: Sequence = ()) -> np.ndarray:
        """One utterance -> float32 24 kHz waveform (a recycled slot).
        Raises ServerOverloaded when max_pending requests already queue for
        a slot."""
        if not self._started:
            await self.start()
        if self.max_pending is not None and \
                self.engine.pending() >= self.max_pending:
            raise ServerOverloaded(
                f"{self.engine.pending()} requests pending (max_pending="
                f"{self.max_pending})")
        loop = asyncio.get_running_loop()
        res = self.engine.submit(text, speaker, tuple(context))
        fut: asyncio.Future = loop.create_future()

        def finalize() -> np.ndarray:
            # in the executor after completion: the chunks are all there,
            # and the watermark (a whole-utterance STFT) must not stall
            # the event loop
            audio = res.audio()
            if self.watermark_key is not None:
                from csm_mlx_tpu_torch.watermark import embed_watermark

                # on the model's device, as the lockstep server's marks
                audio = embed_watermark(
                    torch.from_numpy(audio), self.watermark_key,
                    device=self.engine.device).cpu().numpy()
            return audio

        def schedule() -> None:
            if fut.done():
                return
            t = loop.run_in_executor(None, finalize)

            def copy(f) -> None:
                if fut.done():
                    return
                exc = f.exception()
                fut.set_exception(exc) if exc else fut.set_result(f.result())

            t.add_done_callback(copy)

        def on_done() -> None:
            try:
                loop.call_soon_threadsafe(schedule)
            except RuntimeError:
                pass  # the loop closed: nobody waits

        res.add_done_callback(on_done)
        self.stats.flight(1)
        try:
            audio = await fut
        except BaseException:
            res.cancel()
            raise
        finally:
            self.stats.flight(-1)
        self.stats.requests += 1
        self.stats.audio_seconds += audio.shape[-1] / SAMPLING_RATE
        return audio

    async def synthesize_stream(self, text: str, speaker: int = 0,
                                context: Sequence = ()):
        """Async iterator of 1,920-sample float32 chunks; no device lock:
        any number of streams ride the same batched loop. Raises
        ServerOverloaded as `synthesize` does (streams are slots too)."""
        if not self._started:
            await self.start()
        if self.max_pending is not None and \
                self.engine.pending() >= self.max_pending:
            raise ServerOverloaded(
                f"{self.engine.pending()} requests pending (max_pending="
                f"{self.max_pending})")
        loop = asyncio.get_running_loop()
        res = self.engine.submit(text, speaker, tuple(context))
        q: asyncio.Queue = asyncio.Queue()
        done = object()

        def deliver(chunk) -> None:
            # on the engine's thread; None is the end (the error, if any,
            # is set on res before it)
            if chunk is None:
                chunk = res.error if res.error is not None else done
            try:
                loop.call_soon_threadsafe(q.put_nowait, chunk)
            except RuntimeError:
                pass  # the loop closed mid-stream

        res.set_chunk_callback(deliver)
        self.stats.flight(1)
        n_samples = 0
        try:
            while True:
                item = await q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                n_samples += item.shape[-1]
                yield item
        finally:
            self.stats.flight(-1)
            res.cancel()  # frees the slot unless already complete
        self.stats.requests += 1
        self.stats.audio_seconds += n_samples / SAMPLING_RATE


def wav_bytes(audio: np.ndarray, sample_rate: int = SAMPLING_RATE) -> bytes:
    """16-bit PCM RIFF/WAVE encoding of a float waveform (in memory)."""
    pcm = (np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
           * 32767.0).astype("<i2").tobytes()
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(pcm)))
    buf.write(b"WAVEfmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                          sample_rate * 2, 2, 16))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(pcm)))
    buf.write(pcm)
    return buf.getvalue()


class _HttpError(Exception):
    """A client-input error with the HTTP status to answer."""

    def __init__(self, status: str, message: str):
        super().__init__(message)
        self.status = status


# Request bodies are tiny JSON; the cap holds before anything is buffered.
MAX_BODY_BYTES = 1 << 20


async def _read_http_request(reader: asyncio.StreamReader):
    request_line = await reader.readline()
    if not request_line:
        return None, None, b""
    try:
        method, path, _ = request_line.decode("latin-1").split(" ", 2)
    except ValueError:
        return None, None, b""
    content_length = 0
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode("latin-1").partition(":")
        if name.strip().lower() == "content-length":
            try:
                content_length = int(value.strip())
            except ValueError:
                raise _HttpError("400 Bad Request",
                                 "malformed Content-Length")
    if content_length < 0:
        raise _HttpError("400 Bad Request", "malformed Content-Length")
    if content_length > MAX_BODY_BYTES:
        raise _HttpError("413 Payload Too Large",
                         f"body exceeds {MAX_BODY_BYTES} bytes")
    body = await reader.readexactly(content_length) if content_length else b""
    return method, path, body


def _parse_tts_body(body: bytes):
    """(text, speaker) from a request body; client errors -> 400."""
    try:
        req = json.loads(body or b"{}")
        text = req["text"]
        speaker = int(req.get("speaker", 0))
    except (ValueError, KeyError, TypeError):
        raise _HttpError(
            "400 Bad Request",
            'body must be JSON with a "text" field (and optional '
            'integer "speaker")')
    if not isinstance(text, str):
        raise _HttpError("400 Bad Request", '"text" must be a string')
    return text, speaker


def _http_response(status: str, content_type: str, body: bytes) -> bytes:
    head = (f"HTTP/1.1 {status}\r\nContent-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n")
    return head.encode("latin-1") + body


async def serve_http(server, host: str = "127.0.0.1", port: int = 8080):
    """Start the HTTP front end over a `TTSServer` or `ContinuousTTSServer`;
    returns the asyncio.Server (an ephemeral port is readable from
    `.sockets[0].getsockname()`)."""

    async def handle(reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter):
        streamed = False  # the chunked 200 header is on the wire
        try:
            method, path, body = await _read_http_request(reader)
            if method is None:
                return
            if method == "GET" and path == "/healthz":
                writer.write(_http_response("200 OK", "text/plain", b"ok"))
            elif method == "GET" and path == "/stats":
                s = server.stats
                stats = {
                    "requests": s.requests, "batches": s.batches,
                    "batch_sizes": list(s.batch_sizes),
                    "aggregate_rtf": s.aggregate_rtf,
                }
                engine = getattr(server, "engine", None)
                if engine is not None:  # the continuous server's scheduler
                    es = engine.stats
                    stats["engine"] = {
                        "steps": es.steps, "admissions": es.admissions,
                        "completed": es.completed, "rebases": es.rebases,
                        "frames_emitted": es.frames_emitted,
                        "frames_wasted": es.frames_wasted,
                        **es.first_chunk_latency_ms(),
                    }
                payload = json.dumps(stats).encode()
                writer.write(_http_response("200 OK", "application/json",
                                            payload))
            elif method == "POST" and path == "/tts-stream":
                text, speaker = _parse_tts_body(body)
                # The 200 header waits for the first chunk, so a failure
                # before the stream (overload, a generation error) still
                # answers with its status.
                gen = server.synthesize_stream(text, speaker)
                first = None
                overloaded: Optional[ServerOverloaded] = None
                try:
                    first = await gen.__anext__()
                except StopAsyncIteration:
                    pass  # an empty stream is still a valid 200
                except ServerOverloaded as exc:
                    overloaded = exc
                if overloaded is not None:
                    writer.write(_http_response(
                        "503 Service Unavailable", "application/json",
                        json.dumps({"error": str(overloaded)}).encode()))
                else:
                    writer.write(
                        b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: audio/L16; rate=24000\r\n"
                        b"Transfer-Encoding: chunked\r\n"
                        b"Connection: close\r\n\r\n")
                    streamed = True

                    async def _rest():
                        if first is not None:
                            yield first
                        async for c in gen:
                            yield c

                    async for chunk in _rest():
                        pcm = (np.clip(chunk, -1.0, 1.0)
                               * 32767.0).astype("<i2").tobytes()
                        writer.write(f"{len(pcm):x}\r\n".encode())
                        writer.write(pcm + b"\r\n")
                        await writer.drain()
                    writer.write(b"0\r\n\r\n")
            elif method == "POST" and path == "/tts":
                text, speaker = _parse_tts_body(body)
                try:
                    audio = await server.synthesize(text, speaker)
                except ServerOverloaded as exc:
                    writer.write(_http_response(
                        "503 Service Unavailable", "application/json",
                        json.dumps({"error": str(exc)}).encode()))
                else:
                    writer.write(_http_response("200 OK", "audio/wav",
                                                wav_bytes(audio)))
            else:
                writer.write(_http_response("404 Not Found", "text/plain",
                                            b"not found"))
            await writer.drain()
        except _HttpError as exc:
            try:
                writer.write(_http_response(
                    exc.status, "application/json",
                    json.dumps({"error": str(exc)}).encode()))
                await writer.drain()
            except Exception:
                pass
        except BaseException as exc:
            # the continuous stream re-raises engine errors latched as
            # BaseException: the chunked framing still ends cleanly
            try:
                if streamed:
                    # a 500 body would corrupt the chunked framing
                    writer.write(b"0\r\n\r\n")
                else:
                    writer.write(_http_response(
                        "500 Internal Server Error", "application/json",
                        json.dumps({"error": str(exc)}).encode()))
                await writer.drain()
            except Exception:
                pass
            if not isinstance(exc, Exception):
                raise  # CancelledError / KeyboardInterrupt
        finally:
            writer.close()

    await server.start()
    return await asyncio.start_server(handle, host, port)

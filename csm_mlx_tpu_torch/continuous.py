"""Continuous batching: per-slot admission into a running generation batch
(port of `csm_mlx_tpu/continuous.py`).

The lockstep batch path (`generation.generate_batch`) holds every row until
the whole batch finishes. This engine keeps a fixed batch of B slots
stepping forever and recycles each row the moment its stream ends.

Why it is exact, as in the JAX package:
- A new request is spliced into a shared KV cache mid-flight by writing
  its prefilled K/V at slots [index - P, index) of its row and setting its
  pad to index - P + its own left pad: its positions then start at 0 and it
  never sees its dead predecessor's keys. The shared cache index, and so
  the step block, is untouched.
- A step block decodes the codec audio of the frame it was given and of
  its first K - 1 frames ("decode-behind"), so an admitted row's first
  frame flows through the next block's Mimi step; admission resets only
  the row's own codec state (`mimi.reset_decode_row`).
- The cache is compacted in place (`_rebase`): the live slots move down by
  the lowest live left pad. Positions are pad-relative, so a rebase is
  exact.

On the card a step block (K frames and the decode-behind Mimi step of the
K frames owed) is one CUDA graph, replayed per block. The backbone cache
is one buffer at the full capacity; a block's attention reads a prefix
view of it, `cache.k[..., :bucket, :]`, the smallest KV bucket
(`ops.attention.kv_prefix_buckets`) over the live slots. Each bucket has
its graph, captured over its view of the same buffer on its second use
(the first runs the block eagerly on a side stream) and kept, so a bucket
change copies nothing and never captures again. The graphs share one
memory pool and the caller's generator, so kernel 3's seeds and the c0
draws are new at every replay. A replay adds the launches its capture
recorded to the wrappers' counters (`ops.launches`). An admission (the
prefill of same-bucket prompts, the splice, the first frame) runs eagerly
on the stream the replays use. After each block, on the same stream, its
frames, EOS flags and chunks are copied into that flight's pinned host
buffers with an event; the host reads a flight after its event, so the
card runs block k+1 while the host reads block k (`pipeline_depth`).

On the CPU, or with `eager=True`, the same block runs eagerly.

Token parity with the one-shot path holds at temperature 0 on the CPU in
fp32: a row admitted mid-flight gives the frames of `generate_tokens` run
alone.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from csm_mlx_tpu_torch.generation import (HISTORY_SIZE, _assemble_prompt,
                                          _backbone_step, _decode_frame,
                                          _draw_seeds, _frame_to_next_input,
                                          _pad_prompt, _prefill,
                                          _resolve_sampler,
                                          _use_resident_decoder)
from csm_mlx_tpu_torch.models.csm import CSM
from csm_mlx_tpu_torch.ops import launches
from csm_mlx_tpu_torch.ops.attention import kv_bucket_for, kv_prefix_buckets
from csm_mlx_tpu_torch.ops.kv_cache import KVCache
from csm_mlx_tpu_torch.ops.rope import rope_cache_for

logger = logging.getLogger(__name__)


class ContinuousResult:
    """Handle of one submitted request.

    `chunks` yields 80 ms audio chunks (np.float32, only when the engine
    runs with a codec); `wait()` blocks until the stream is complete and
    returns the (F, 32) token matrix. After `done` is set, `.audio()` and
    `.tokens` may be read too.
    """

    def __init__(self, max_frames: int, n_codebooks: int = 32):
        self.max_frames = max_frames
        self.n_codebooks = n_codebooks
        # host perf_counter stamps: submit -> admitted -> first chunk
        self.t_submit: Optional[float] = None
        self.t_admitted: Optional[float] = None
        self.t_first_chunk: Optional[float] = None
        self.tokens: List[np.ndarray] = []
        self._chunks: "queue.Queue[Optional[np.ndarray]]" = queue.Queue()
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.audio_frames = 0
        self.finished = False  # no more token frames will be accepted
        self.finish_reason: Optional[str] = None  # eos | cap | cancel | error
        self.cancelled = False
        self._lat_recorded = False
        self._cb_lock = threading.Lock()
        self._on_chunk: Optional[Callable] = None
        self._on_done: Optional[Callable] = None

    def cancel(self) -> None:
        """Stop this stream at the next fetched frame (or drop it from the
        queue if not yet admitted). What was emitted stays readable."""
        self.cancelled = True

    # -- engine side ----------------------------------------------------
    def _push_chunk(self, chunk: np.ndarray) -> None:
        with self._cb_lock:
            if self.done.is_set():
                # "chunks, then one final None": nothing after the sentinel
                return
            if self.t_first_chunk is None:
                self.t_first_chunk = time.perf_counter()
            self.audio_frames += 1
            if self._on_chunk is not None:
                try:
                    self._on_chunk(chunk)
                except Exception:  # a consumer bug must not kill the engine
                    logger.exception("chunk callback raised")
            else:
                self._chunks.put(chunk)

    def _finish(self, error: Optional[BaseException] = None) -> None:
        with self._cb_lock:
            if self.done.is_set():
                return  # callbacks fire exactly once
            self.error = error
            self.finished = True
            if self.finish_reason is None:
                self.finish_reason = ("error" if error is not None
                                      else "cancel" if self.cancelled
                                      else None)
            if self._on_chunk is not None:
                try:
                    self._on_chunk(None)
                except Exception:
                    logger.exception("chunk callback raised")
            else:
                self._chunks.put(None)
            self.done.set()
            cb = self._on_done
        if cb is not None:
            try:
                cb()
            except Exception:
                logger.exception("done callback raised")

    # -- caller-side callbacks -------------------------------------------
    def add_done_callback(self, cb: Callable) -> None:
        """cb() once when the stream completes, on the engine's thread (keep
        it short); at once if already complete. One callback at most."""
        with self._cb_lock:
            self._on_done = cb
            fire = self.done.is_set()
        if fire:
            cb()

    def set_chunk_callback(self, cb: Callable) -> None:
        """Deliver the chunks (and the final None) through cb instead of the
        queue, queued chunks first, in order; on the engine's thread. After
        this, `chunks()` and `audio()` must not be used."""
        with self._cb_lock:
            self._on_chunk = cb
            while True:
                try:
                    item = self._chunks.get_nowait()
                except queue.Empty:
                    break
                try:
                    cb(item)
                except Exception:
                    logger.exception("chunk callback raised")

    # -- caller side ----------------------------------------------------
    def chunks(self):
        while True:
            c = self._chunks.get()
            if c is None:
                # put the sentinel back: a second consumer ends too
                self._chunks.put(None)
                if self.error is not None:
                    raise self.error
                return
            yield c

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if self.error is not None:
            raise self.error
        return self.token_matrix()

    def token_matrix(self) -> np.ndarray:
        if self.tokens:
            return np.stack(self.tokens, axis=0)
        return np.zeros((0, self.n_codebooks), dtype=np.int32)

    def audio(self) -> np.ndarray:
        parts = list(self.chunks())
        if not parts:
            return np.zeros((0,), dtype=np.float32)
        return np.concatenate(parts, axis=0)


@dataclasses.dataclass
class _Slot:
    req: Optional[ContinuousResult] = None
    # the request whose frame is in this row's carry, and its 0-based
    # frame number
    prov_req: Optional[ContinuousResult] = None
    prov_seq: int = -1
    # a cap-finished row whose last chunk is still in flight: block number
    # `flush_step` must have been dispatched before an admit overwrites it
    flush_step: Optional[int] = None


@dataclasses.dataclass
class ContinuousStats:
    steps: int = 0
    admissions: int = 0
    admit_batches: int = 0  # admission prefills (<= 16 same-bucket rows)
    rebases: int = 0
    cache_resizes: int = 0  # KV-bucket changes, grows and shrinks
    cache_grows: int = 0
    graph_captures: int = 0  # step-block graphs captured (one a bucket)
    completed: int = 0
    frames_emitted: int = 0
    frames_wasted: int = 0  # dead-slot frames computed and discarded
    # rolling reservoirs (the last 1024) of first-chunk latency, seconds:
    # admission -> first chunk, and submit -> first chunk
    admit_to_first_chunk: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=1024))
    submit_to_first_chunk: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=1024))

    def first_chunk_latency_ms(self) -> Dict[str, Optional[float]]:
        """p50/p90/p99 of the first-chunk latencies in ms (None before a
        codec stream delivered audio)."""
        out: Dict[str, Optional[float]] = {}
        for name, d in (("admit", self.admit_to_first_chunk),
                        ("submit", self.submit_to_first_chunk)):
            arr = np.asarray(d.copy(), np.float64)  # read while appended
            for q in (50, 90, 99):
                out[f"{name}_p{q}_ms"] = (
                    round(float(np.percentile(arr, q)) * 1e3, 1)
                    if arr.size else None)
        return out


@dataclasses.dataclass
class _Flight:
    """A dispatched block's or admission's outputs on their way to the
    host: host tensors (pinned on the card) and the event after their
    copies (None on the CPU)."""
    host: Tuple[torch.Tensor, ...]
    event: Optional[Any] = None

    def get(self) -> Tuple[np.ndarray, ...]:
        if self.event is not None:
            self.event.synchronize()
        return tuple(t.numpy() for t in self.host)


def _shift_left(buf: torch.Tensor, shift: int, n: int) -> None:
    """buf[..., :n, :] = buf[..., shift:shift + n, :] along the slot axis
    (3), in place, through a staging buffer of at most 256 slots."""
    width = min(n, 256)
    tmp = torch.empty_like(buf[:, :, :, :width])
    for lo in range(0, n, width):
        w = min(width, n - lo)
        tmp[:, :, :, :w].copy_(buf[:, :, :, lo + shift:lo + shift + w])
        buf[:, :, :, lo:lo + w].copy_(tmp[:, :, :, :w])


class ContinuousEngine:
    """A fixed batch of slots over the step block, admission and rebase.

    `submit` may be called from any thread; the device is driven either by
    an owned thread (`start`/`stop`) or by the caller through
    `run_until_idle` (tests, benchmarks), not both at once.

    The JAX package's `key` is `generator`, a `torch.Generator` on the
    model's device (default: one seeded at random). `flash_decode_min_b`
    runs each backbone step's attention through kernel 4 at B >= it, as in
    `generate_tokens_batch` (None: never). `mimi` is the codec (default
    the `get_audio_tokenizer` singleton on the model's device). `eager`
    runs every block eagerly on the card, for comparing.
    """

    # admissions pad up to the next of these batch sizes (by repeating the
    # last row; its later write wins), as the JAX package's compiled sizes
    _ADMIT_SIZES = (1, 2, 4, 8, 16)
    # the Mimi ring's position counter is rebased long before its rotary
    # phase could lose precision: 2^18 frames, ~5.8 h of audio
    _MIMI_REBASE_AT = 1 << 18
    # bucketed cache: rebase once >= 256 positions of shift are free, and
    # keep half a bucket step of slack before shrinking the bucket
    _EAGER_REBASE_SHIFT = 256
    _SHRINK_HYSTERESIS = 128

    def __init__(
        self,
        model: CSM,
        n_slots: int = 8,
        *,
        max_frames: int = 1250,          # 100 s, per-request hard cap
        max_prompt_bucket: int = 512,
        capacity_slack: int = 128,
        temperature: float = 0.0,
        sampler: Optional[Any] = None,
        logits_processors: Optional[Sequence] = None,
        codec: bool = True,
        quantize_codec: bool = False,
        frames_per_step: int = 8,
        pipeline_depth: int = 2,
        transfer: str = "float32",
        mesh: Optional[Any] = None,
        generator: Optional[torch.Generator] = None,
        flash_decode_min_b: Optional[int] = None,
        mimi=None,
        eager: bool = False,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "ContinuousEngine(mesh=...): parallelism is not ported yet "
                "(ROADMAP queue 1, item 12)")
        if quantize_codec:
            raise NotImplementedError(
                "ContinuousEngine(quantize_codec=True): the int8 codec "
                "(models/mimi/quant.py) is not ported; it waits for a "
                "measurement (ROADMAP queue 1)")
        if transfer not in ("float32", "int16"):
            raise ValueError(f"transfer must be 'float32' or 'int16', "
                             f"got {transfer!r}")
        args = model.args
        device = model.device
        self.model, self.args, self.device = model, args, device
        self.n_slots = n_slots
        self.max_frames = max_frames
        self.max_prompt_bucket = max_prompt_bucket
        self.frames_per_step = k = max(1, frames_per_step)
        self.pipeline_depth = max(1, pipeline_depth)
        self.transfer = transfer
        self.flash_decode_min_b = flash_decode_min_b
        ctx = args.backbone_config.max_position_embeddings or 2048
        if max_prompt_bucket + max_frames > ctx:
            raise ValueError(
                f"max_prompt_bucket+max_frames ({max_prompt_bucket}+"
                f"{max_frames}) exceeds the backbone context window {ctx}")
        if capacity_slack < k:
            raise ValueError(
                f"capacity_slack ({capacity_slack}) must cover at least one "
                f"step block (frames_per_step={k}) so a rebase always frees "
                f"room for the next block")
        self.capacity = max_prompt_bucket + max_frames + capacity_slack
        self._bootstrap = max_prompt_bucket
        self._sampler = _resolve_sampler(temperature, sampler)
        self._processors = tuple(logits_processors or ())
        self._capture = device.type == "cuda" and not eager
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(int(np.random.randint(0, 2 ** 31 - 1)))
        if generator.device != device:
            raise ValueError(f"the engine draws on {device}; the generator "
                             f"is on {generator.device}")
        self.generator = generator

        self._mimi = None
        if codec:
            if mimi is None:
                from csm_mlx_tpu_torch.tokenizers import get_audio_tokenizer

                mimi = get_audio_tokenizer(args.n_audio_codebooks,
                                           device=device)
            self._mimi = mimi

        bcfg = args.backbone_config
        self._cos_b, self._sin_b = rope_cache_for(
            bcfg, max(self.capacity, bcfg.max_position_embeddings), device)
        self._cos_d, self._sin_d = rope_cache_for(
            args.decoder_config, args.n_audio_codebooks + 1, device)

        # Device state, updated in place -----------------------------------
        # One cache buffer at the full capacity; each step block reads a
        # prefix view of it (the current bucket).
        self._kv_buckets = kv_prefix_buckets(self.capacity)
        self._cache = KVCache.init(bcfg, n_slots, self.capacity,
                                   dtype=model.dtype, device=device)
        self._cache.index.fill_(self._bootstrap)
        self._cache.length = self._bootstrap
        self._cap = (kv_bucket_for(self._bootstrap + k, self._kv_buckets)
                     or self.capacity)
        self._views: Dict[int, KVCache] = {}
        n_cb = args.n_audio_codebooks
        self._pad = torch.full((n_slots,), self._bootstrap - 1,
                               dtype=torch.long, device=device)
        self._frame = torch.zeros((n_slots, n_cb), dtype=torch.long,
                                  device=device)
        self._history = torch.full((n_slots, HISTORY_SIZE), -1,
                                   dtype=torch.long, device=device)
        self._seeds = torch.zeros(
            (_use_resident_decoder(model.params, self._sampler, n_slots),),
            dtype=torch.int32, device=device)
        self._frame_in = torch.zeros_like(self._frame)
        self._frames = torch.zeros((k, n_slots, n_cb), dtype=torch.long,
                                   device=device)
        self._eos = torch.zeros((k, n_slots), dtype=torch.bool, device=device)
        self._chunks = None
        self._dec_state = None
        if self._mimi is not None:
            # the ring takes one block's K frames (2K tokens) a step
            self._dec_state = self._mimi.init_decode_state(
                n_slots, chunk_frames=k)
            self._chunks = torch.zeros(
                (k, n_slots, self._mimi.frame_size),
                dtype=torch.int16 if transfer == "int16" else torch.float32,
                device=device)
        self._graphs: Dict[int, Any] = {}   # bucket -> "warm" | graph
        self._captured: Dict[int, dict] = {}  # bucket -> launches a replay
        self._pool = None
        self._stream = None
        self._free_host: List[Tuple[torch.Tensor, ...]] = []

        # Host mirrors and scheduler state ---------------------------------
        self._idx = self._bootstrap          # mirror of the cache index
        self._pads: List[int] = [self._bootstrap - 1] * n_slots
        self._slots = [_Slot() for _ in range(n_slots)]
        self._queue: "queue.Queue[Tuple]" = queue.Queue()
        self._inflight: deque = deque()      # (kind, payload, _Flight)
        self._step_no = 0                    # step blocks dispatched
        self._frames_total = 0               # frames stepped (blocks * K)
        self._mimi_rebased = 0               # Mimi index shifted (tokens)
        self.stats = ContinuousStats()
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # set when the drive loop dies: later submits fail at once
        self._dead: Optional[BaseException] = None
        # a list to time the parts of the eager blocks on the card (`_block`)
        self.block_marks: Optional[list] = None

    # -- submission ------------------------------------------------------

    @property
    def has_codec(self) -> bool:
        """True when the engine decodes audio."""
        return self._mimi is not None

    @property
    def kv_capacity(self) -> int:
        """The slots of the cache the next step block reads (its bucket)."""
        return self._cap

    def pending(self) -> int:
        """Requests waiting for a slot (approximate)."""
        return self._queue.qsize()

    def submit(self, text: str, speaker: int = 0, context: Sequence = (),
               max_frames: Optional[int] = None) -> ContinuousResult:
        prompt, mask = _assemble_prompt(self.model, text, speaker, context,
                                        self._mimi)
        return self.submit_prompt(prompt, mask, max_frames=max_frames)

    def submit_prompt(self, prompt: np.ndarray, mask: np.ndarray,
                      max_frames: Optional[int] = None) -> ContinuousResult:
        if self._dead is not None:
            raise RuntimeError(
                "continuous engine died; restart a new engine") \
                from self._dead
        mf = (self.max_frames if max_frames is None
              else min(max_frames, self.max_frames))
        if mf < 1:
            raise ValueError(f"max_frames must be >= 1, got {max_frames}")
        tokens, m, pad_arr, bucket = _pad_prompt(prompt, mask)
        if bucket > self.max_prompt_bucket:
            raise ValueError(
                f"prompt of {prompt.shape[0]} tokens exceeds the engine's "
                f"max_prompt_bucket={self.max_prompt_bucket}")
        res = ContinuousResult(mf, self.args.n_audio_codebooks)
        res.t_submit = time.perf_counter()
        self._queue.put((res, tokens, m, int(pad_arr[0]), bucket))
        self._wake.set()
        return res

    # -- device programs ---------------------------------------------------

    def _view(self, bucket: int) -> KVCache:
        """The cache's first `bucket` slots, sharing its buffers and its
        index tensor."""
        view = self._views.get(bucket)
        if view is None:
            full = self._cache
            view = KVCache(k=full.k[:, :, :, :bucket],
                           v=full.v[:, :, :, :bucket], length=0)
            view.index = full.index
            self._views[bucket] = view
        view.length = self._idx
        return view

    @torch.no_grad()
    def _block(self, cache: KVCache, marks: Optional[list] = None) -> None:
        """K frames and the decode-behind Mimi step of the K frames owed,
        into the static buffers. `marks` (eager on the card only): a list
        that gets a timing CUDA event at the start, after each backbone
        step, after each frame's decode and after the Mimi step."""
        def mark() -> None:
            if marks is not None:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()

        params, args = self.model.params, self.args
        mark()
        self._frame_in.copy_(self._frame)
        for j in range(self.frames_per_step):
            tokens, mask = _frame_to_next_input(self._frame)
            last_hidden, _ = _backbone_step(
                params, args, tokens, mask, self._pad, cache, self._cos_b,
                self._sin_b, self.flash_decode_min_b)
            mark()
            if self._seeds.numel():
                self._seeds.copy_(_draw_seeds(self.generator, self._sampler,
                                              self._seeds.numel(),
                                              self.device))
            frame, history = _decode_frame(
                params, args, last_hidden, self.generator, self._history,
                self._sampler, self._processors, self._cos_d, self._sin_d,
                seeds=self._seeds if self._seeds.numel() else None)
            self._frame.copy_(frame)
            self._history.copy_(history)
            self._frames[j].copy_(frame)
            self._eos[j].copy_((frame == 0).all(dim=1))
            mark()
        if self._mimi is not None:
            from csm_mlx_tpu_torch.models.mimi.mimi import mimi_decode_step_fn

            # the frame that entered the block, then its first K - 1
            owed = torch.cat([self._frame_in[None], self._frames[:-1]])
            audio, _ = mimi_decode_step_fn(
                self._mimi.params, self._mimi.cfg,
                owed.permute(1, 2, 0).contiguous(), self._dec_state)
            k, b = self.frames_per_step, self.n_slots
            chunks = audio.reshape(b, k, -1).transpose(0, 1)
            if self.transfer == "int16":
                # PCM16 on the device: half the bytes to the host; values
                # land on the 16-bit grid
                chunks = (torch.clamp(chunks, -1.0, 1.0)
                          * 32767.0).to(torch.int16)
            self._chunks.copy_(chunks)
            mark()

    def _run_block(self) -> None:
        cache = self._view(self._cap)
        if not self._capture:
            self._block(cache, self.block_marks)
            return
        graph = self._graphs.get(self._cap)
        if graph is None:
            # first use of the bucket: the block runs eagerly on a side
            # stream (a real block, which also does every first-use set-up)
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                self._block(cache)
            torch.cuda.current_stream().wait_stream(self._stream)
            self._graphs[self._cap] = "warm"
            return
        if graph == "warm":
            graph = self._capture_block(cache)
        graph.replay()
        for (fn, attr), n in self._captured[self._cap].items():
            setattr(fn, attr, getattr(fn, attr) + n)

    def _capture_block(self, cache: KVCache):
        counters = list(launches.COUNTERS.values())
        before = [getattr(fn, attr) for fn, attr in counters]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            self._block(cache)
        cache.length = self._idx  # the capture ran nothing
        captured = {}
        for (fn, attr), n in zip(counters, before):
            if getattr(fn, attr) != n:
                captured[(fn, attr)] = getattr(fn, attr) - n
                setattr(fn, attr, n)
        if self._pool is None:
            self._pool = graph.pool()
        self._graphs[self._cap] = graph
        self._captured[self._cap] = captured
        self.stats.graph_captures += 1
        return graph

    def _to_host(self, tensors: Tuple[torch.Tensor, ...],
                 reuse: bool) -> _Flight:
        """The tensors' values on their way to the host: on the card,
        copies into pinned buffers (a free set when `reuse`) and an event
        after them, on the current stream; on the CPU, clones."""
        if self.device.type != "cuda":
            return _Flight(tuple(t.clone() for t in tensors))
        host = self._free_host.pop() if reuse and self._free_host else tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Flight(host, event)

    @torch.no_grad()
    def _admit(self, tokens, mask, pads, rows) -> _Flight:
        """Prefill N same-bucket prompts, splice their K/V into rows `rows`
        at [index - P, index), set their pads, first frames and histories,
        and reset their codec rows; duplicate rows: the last write wins."""
        params, args, dev = self.model.params, self.args, self.device
        n, p = tokens.shape[0], tokens.shape[1]
        row_cache = KVCache.init(args.backbone_config, n, p,
                                 dtype=self.model.dtype, device=dev)
        pads_t = torch.from_numpy(pads).long().to(dev)
        last_hidden, _ = _prefill(
            params, args, torch.from_numpy(tokens).long().to(dev),
            torch.from_numpy(mask).long().to(dev), pads_t, row_cache,
            self._cos_b, self._sin_b)
        at = self._idx - p
        full = self._cache
        hist_n = torch.full((n, HISTORY_SIZE), -1, dtype=torch.long,
                            device=dev)
        f_n, hist_n = _decode_frame(params, args, last_hidden,
                                    self.generator, hist_n, self._sampler,
                                    self._processors, self._cos_d,
                                    self._sin_d)
        for t in range(n):  # sequential: the last write wins
            r = int(rows[t])
            full.k[:, r, :, at:at + p].copy_(row_cache.k[:, t])
            full.v[:, r, :, at:at + p].copy_(row_cache.v[:, t])
            self._pad[r] = at + int(pads[t])
            self._frame[r].copy_(f_n[t])
            self._history[r].copy_(hist_n[t])
            if self._dec_state is not None:
                from csm_mlx_tpu_torch.models.mimi.mimi import \
                    reset_decode_row

                reset_decode_row(self._dec_state, r)
        return self._to_host((f_n, (f_n == 0).all(dim=1)), reuse=False)

    def _rebase(self, shift: int) -> None:
        """Move the live slots [shift, index) down to [0, index - shift) in
        place; positions are pad-relative, so this is exact. Dead rows'
        stale pads are clamped so their (discarded) attention keeps a
        valid key."""
        n = self._idx - shift
        for buf in (self._cache.k, self._cache.v):
            _shift_left(buf, shift, n)
        self._cache.index.sub_(shift)
        self._pad.copy_(torch.minimum(self._pad - shift,
                                      self._cache.index.long() - 1))

    def _mimi_rebase(self, shift: int) -> None:
        """Shift the Mimi ring's position counter down by a multiple of its
        window (slots stay where they are), in place."""
        tr = self._dec_state.transformer
        tr.index.sub_(shift)
        tr.start.copy_(torch.clamp(tr.start - shift, min=0))

    # -- scheduling core -------------------------------------------------

    def _free_slot(self, exclude: Optional[set] = None) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if exclude is not None and i in exclude:
                continue
            if s.req is None and (
                s.flush_step is None or self._step_no >= s.flush_step
            ):
                return i
        return None

    def _active(self) -> bool:
        return any(s.req is not None for s in self._slots)

    def _flushing(self) -> bool:
        return any(s.flush_step is not None for s in self._slots)

    def _dispatch_admit(self, assignments: List[Tuple[int, Tuple]]) -> None:
        """Splice a same-bucket group of (slot, queue item) at once."""
        n_real = len(assignments)
        n = next(s for s in self._ADMIT_SIZES if s >= n_real)
        bucket = assignments[0][1][4]
        width = assignments[0][1][1].shape[2]
        tokens = np.zeros((n, bucket, width), np.int32)
        mask = np.zeros((n, bucket, width), np.int32)
        pads = np.zeros((n,), np.int32)
        rows = np.zeros((n,), np.int32)
        for t in range(n):
            slot_i, (res, tk, m, pad, _b) = assignments[min(t, n_real - 1)]
            tokens[t], mask[t], pads[t], rows[t] = tk[0], m[0], pad, slot_i
        flight = self._admit(tokens, mask, pads, rows)
        t_adm = time.perf_counter()
        for slot_i, (res, _tk, _m, pad, _b) in assignments:
            res.t_admitted = t_adm
            self._pads[slot_i] = self._idx - bucket + pad
            s = self._slots[slot_i]
            s.req = res
            s.prov_req, s.prov_seq = res, 0
            s.flush_step = None
        # the block dispatched next (number _step_no + 1) decodes the
        # admitted frame's audio in its first iteration
        self._inflight.append(
            ("admit",
             ([(slot_i, res) for slot_i, (res, *_r) in assignments],
              self._step_no + 1),
             flight))
        self.stats.admissions += n_real
        self.stats.admit_batches += 1

    def _set_bucket(self, bucket: int) -> None:
        """The prefix of the cache the next blocks read (no copy: every
        bucket is a view of the one buffer)."""
        if bucket == self._cap:
            return
        if bucket > self._cap:
            self.stats.cache_grows += 1
        self._cap = bucket
        self.stats.cache_resizes += 1

    def _dispatch_step(self) -> None:
        k = self.frames_per_step
        if self._idx + k > self._cap:
            self._set_bucket(kv_bucket_for(self._idx + k, self._kv_buckets)
                             or self.capacity)
        prov = [(s.prov_req, s.prov_seq) for s in self._slots]
        self._run_block()
        outs = (self._frames, self._eos) + (
            (self._chunks,) if self._chunks is not None else ())
        flight = self._to_host(outs, reuse=True)
        self._idx += k
        self._cache.length = self._idx
        self._step_no += 1
        self._frames_total += k
        for s in self._slots:
            if s.prov_req is not None:
                s.prov_seq += k
        self._inflight.append(("step", (prov, self._step_no), flight))
        self.stats.steps += 1

    def _maybe_rebase(self) -> None:
        if self._mimi is not None:
            # the codec transformer takes `downsample_stride` tokens a
            # frame: count in tokens
            tok_per_frame = self._mimi.cfg.downsample_stride
            tok_idx = tok_per_frame * self._frames_total - self._mimi_rebased
            if tok_idx >= tok_per_frame * self._MIMI_REBASE_AT:
                w = self._dec_state.transformer.window
                # keep >= 2 windows of positions; multiples of w keep slots
                shift = ((tok_idx - 2 * w) // w) * w
                if shift > 0:
                    self._mimi_rebase(shift)
                    self._mimi_rebased += shift
        at_max = self._idx + self.frames_per_step >= self.capacity
        live = [self._pads[i] for i, s in enumerate(self._slots)
                if s.req is not None]
        low = min(live) if live else self._idx
        shift = min(low, self._idx - self._bootstrap)
        # eager rebase (bucketed cache): compact as soon as a useful shift
        # opens, so the bucket every block reads stays near the live window
        eager = (bool(self._kv_buckets)
                 and shift >= self._EAGER_REBASE_SHIFT)
        if not (at_max or eager):
            return
        if at_max and (shift <= 0 or self._idx - shift +
                       self.frames_per_step >= self.capacity):
            raise RuntimeError(
                "cache full with an unrebaseable row — max_frames/"
                "capacity_slack misconfigured")
        self._rebase(shift)
        self._idx -= shift
        self._cache.length = self._idx
        self._pads = [max(p - shift, 0) for p in self._pads]
        self.stats.rebases += 1
        if self._kv_buckets:
            # shrink, with hysteresis against grow/shrink thrash
            want = (kv_bucket_for(
                self._idx + self.frames_per_step + self._SHRINK_HYSTERESIS,
                self._kv_buckets) or self.capacity)
            if want < self._cap:
                self._set_bucket(want)

    def _fetch_one(self) -> None:
        kind, payload, flight = self._inflight.popleft()
        if kind == "admit":
            rows, flush = payload
            f0, eos0 = flight.get()
            n, n_real = f0.shape[0], len(rows)
            for t, (slot_i, res) in enumerate(rows):
                # the last real row was repeated to pad the batch, and its
                # last copy's write won: read that copy for it
                td = t if (t < n_real - 1 or n == n_real) else n - 1
                if bool(eos0[td]):
                    # a zero-frame stream, finished before its first step
                    self._finish_request(slot_i, n_chunks_pending=False,
                                         reason="eos")
                else:
                    res.tokens.append(np.asarray(f0[td], np.int32))
                    self.stats.frames_emitted += 1
                    if len(res.tokens) >= res.max_frames:
                        # capped at admission: the frame's chunk comes in
                        # the first iteration of the next block
                        self._finish_request(slot_i, n_chunks_pending=True,
                                             reason="cap", flush_step=flush)
            return
        prov, step_no = payload
        host = flight.get()
        frames, eoses = host[0], host[1]
        chunks = host[2] if len(host) > 2 else None
        k = self.frames_per_step
        for i, (req, seq_in) in enumerate(prov):
            slot = self._slots[i]
            if req is None:
                self.stats.frames_wasted += k
                continue
            for j in range(k):
                # audio of frame seq_in + j (decode-behind): its tokens
                # were fetched one iteration earlier, so len(req.tokens)
                # says which frames are real
                s_audio = seq_in + j
                if chunks is not None and 0 <= s_audio < len(req.tokens):
                    c = chunks[j][i]
                    c = (c.astype(np.float32) / 32767.0
                         if c.dtype == np.int16 else c.astype(np.float32))
                    req._push_chunk(c)
                    if req.t_first_chunk is not None \
                            and not req._lat_recorded:
                        req._lat_recorded = True
                        if req.t_admitted is not None:
                            self.stats.admit_to_first_chunk.append(
                                req.t_first_chunk - req.t_admitted)
                        if req.t_submit is not None:
                            self.stats.submit_to_first_chunk.append(
                                req.t_first_chunk - req.t_submit)
                    if req.finished and s_audio == len(req.tokens) - 1:
                        # the last pending chunk of a cap-finished stream
                        req._finish()
                        if slot.req is None and slot.flush_step == step_no:
                            slot.flush_step = None
                # the token frame of iteration j (frame seq_in + j + 1)
                if req is not slot.req or req.finished:
                    self.stats.frames_wasted += 1
                    continue
                if req.cancelled:
                    self._finish_request(i, n_chunks_pending=False,
                                         reason="cancel")
                    continue
                if bool(eoses[j][i]):
                    # the EOS frame is not audio; the last real frame's
                    # chunk came in this iteration above
                    self._finish_request(i, n_chunks_pending=False,
                                         reason="eos")
                    continue
                req.tokens.append(np.asarray(frames[j][i], np.int32))
                self.stats.frames_emitted += 1
                if len(req.tokens) >= req.max_frames:
                    # cap-finished: the last frame's chunk comes in the next
                    # iteration, in this block unless j is its last
                    self._finish_request(
                        i, n_chunks_pending=True, reason="cap",
                        flush_step=step_no if j < k - 1 else step_no + 1)
        if flight.event is not None:
            self._free_host.append(flight.host)

    def _finish_request(self, slot_i: int, *, n_chunks_pending: bool,
                        flush_step: Optional[int] = None,
                        reason: str = "cap") -> None:
        slot = self._slots[slot_i]
        req = slot.req
        if req is None:
            return
        slot.req = None
        self._pads[slot_i] = self._idx  # free rows don't constrain rebase
        self.stats.completed += 1
        req.finished = True
        req.finish_reason = reason
        if self._mimi is None or not n_chunks_pending:
            req._finish()
        else:
            slot.flush_step = flush_step

    # -- drive loops -----------------------------------------------------

    def _drive_once(self) -> bool:
        """One scheduler iteration; False when fully idle."""
        # admissions: free slots from the queue, grouped by prompt bucket
        assigned: set = set()
        groups: Dict[int, List[Tuple[int, Tuple]]] = {}
        while True:
            slot = self._free_slot(exclude=assigned)
            if slot is None or self._queue.empty():
                break
            item = self._queue.get()
            if item[0].cancelled:
                item[0]._finish()
                continue
            bucket = item[4]
            if self._idx < bucket:
                # unreachable while _idx >= _bootstrap >= every bucket;
                # fail the request rather than requeue it for ever
                item[0]._finish(RuntimeError(
                    f"admission bucket {bucket} exceeds cache depth "
                    f"{self._idx} — engine invariant violated"))
                continue
            assigned.add(slot)
            groups.setdefault(bucket, []).append((slot, item))
        for group in groups.values():
            top = self._ADMIT_SIZES[-1]
            for s0 in range(0, len(group), top):
                self._dispatch_admit(group[s0:s0 + top])
        if not self._active() and not self._flushing():
            self._drain()
            return False
        self._maybe_rebase()
        self._dispatch_step()
        while len(self._inflight) > self.pipeline_depth:
            self._fetch_one()
        return True

    def _drain(self) -> None:
        while self._inflight:
            self._fetch_one()

    def run_until_idle(self) -> None:
        """Drive synchronously until queue and slots are empty."""
        while self._drive_once() or not self._queue.empty():
            pass
        self._drain()

    # -- background thread ------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-engine")
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                busy = self._drive_once()
            except BaseException as e:  # surface device errors to callers
                # latch first: submits racing this failure fail at once
                self._dead = e
                self._fail_all(e)
                raise
            if not busy:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
        self._drain()
        self._fail_all(RuntimeError("engine stopped"))

    def _fail_all(self, err: BaseException) -> None:
        def _kill(req) -> None:
            if req is not None and not req.done.is_set():
                req._finish(err)

        for s in self._slots:
            # flush-pending rows too: their request left s.req but still
            # waits for its last chunk
            for req in (s.req, s.prov_req):
                _kill(req)
            s.req = None
            s.flush_step = None
        # a cap-finished request whose slot was admitted again lives only
        # in the unfetched flights
        while self._inflight:
            kind, payload, _flight = self._inflight.popleft()
            if kind == "admit":
                for _slot_i, res in payload[0]:
                    _kill(res)
            else:
                for req, _seq in payload[0]:
                    _kill(req)
        while not self._queue.empty():
            try:
                self._queue.get_nowait()[0]._finish(err)
            except queue.Empty:
                break

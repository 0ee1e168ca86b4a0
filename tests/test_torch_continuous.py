"""PyTorch port vs JAX package: the continuous-batching engine
(`csm_mlx_tpu_torch/continuous.py`) on the tiny config, fp32, T = 0, on
the CPU (every step block eager).

The cases of `tests/test_continuous.py`, but for the mesh and tiered-KV
ones. Each request's frames must equal the port's solo
`generate_tokens` run exactly (a row admitted mid-flight, after slot reuse
or after a rebase is spliced in through its virtual left pad); the
mid-flight, slot-reuse and rebase cases also hold the port engine's
frames to the JAX engine's on the same parameters. Audio: a recycled
row's chunks against a fresh batch decode of its frames within 2e-3 of
the waveform's peak (the JAX test's tolerance), PCM16 chunks within one
step of the 16-bit grid."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_args
from torch_helpers import torch_model_from_jax
from csm_mlx_tpu.continuous import ContinuousEngine as JEngine
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu_torch import continuous as tcont
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch import tokenizers as ttok
from csm_mlx_tpu_torch.continuous import ContinuousEngine, ContinuousResult
from csm_mlx_tpu_torch.ops.attention import kv_prefix_buckets


@pytest.fixture(scope="module")
def models():
    """A tiny JAX CSM (fp32, 8 codebooks, a random audio_head: a zero head
    would make every decoder codebook 0) and the port's copy of it."""
    jm = jcsm.CSM(tiny_args(n_codebooks=8), dtype=jnp.float32,
                  rng=jax.random.PRNGKey(0))
    jm.params["audio_head"] = jax.random.normal(
        jax.random.PRNGKey(1), jm.params["audio_head"].shape) * 0.5
    return jm, torch_model_from_jax(jm)


@pytest.fixture(scope="module")
def model(models):
    return models[1]


@pytest.fixture
def fresh_codec(monkeypatch):
    """The codec singleton (random-init Mimi of 8 codebooks on the CPU),
    made anew for the test."""
    monkeypatch.delenv(ttok.MIMI_WEIGHTS_ENV, raising=False)
    ttok.get_audio_tokenizer.cache_clear()
    yield
    ttok.get_audio_tokenizer.cache_clear()


def _prompt(args, s, seed=0):
    rng = np.random.RandomState(seed)
    k = args.n_audio_codebooks + 1
    prompt = np.zeros((s, k), dtype=np.int32)
    prompt[:, -1] = rng.randint(3, 200, size=s)
    mask = np.zeros((s, k), dtype=np.int32)
    mask[:, -1] = 1
    return prompt, mask


def _solo(model, prompt, mask, max_frames):
    frames, n = tgen.generate_tokens(model, prompt, mask, max_frames,
                                     temperature=0.0)
    return np.asarray(frames[:int(n)])


def _kw(kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_frames", 12)
    kw.setdefault("max_prompt_bucket", 32)
    kw.setdefault("capacity_slack", 16)
    kw.setdefault("codec", False)
    # 3 frames a block: caps and EOS land mid-block and on block edges
    kw.setdefault("frames_per_step", 3)
    return kw


def _engine(model, **kw):
    return ContinuousEngine(model, generator=torch.Generator().manual_seed(7),
                            **_kw(kw))


def _jax_engine(jm, **kw):
    return JEngine(jm, key=jax.random.PRNGKey(7), **_kw(kw))


def test_single_request_matches_generate_tokens(model):
    eng = _engine(model, frames_per_step=1)  # K=1: a block a frame
    p, m = _prompt(model.args, 5, seed=1)
    res = eng.submit_prompt(p, m, max_frames=6)
    eng.run_until_idle()
    got = res.wait(timeout=0)
    np.testing.assert_array_equal(got, _solo(model, p, m, 6))
    assert eng.stats.completed == 1


def _midflight(make, args):
    eng = make()
    pa, ma = _prompt(args, 5, seed=2)
    pb, mb = _prompt(args, 7, seed=3)
    ra = eng.submit_prompt(pa, ma, max_frames=12)
    for _ in range(4):  # A runs several blocks before B exists
        assert eng._drive_once()
    assert eng.stats.steps >= 4
    rb = eng.submit_prompt(pb, mb, max_frames=5)
    eng.run_until_idle()
    assert eng.stats.admissions == 2
    return [(ra.wait(0), pa, ma, 12), (rb.wait(0), pb, mb, 5)]


def test_midflight_admission_parity(models):
    """A row admitted while another is mid-generation gives exactly its
    solo frames, and the JAX engine's."""
    jm, tm = models
    got = _midflight(lambda: _engine(tm), tm.args)
    want = _midflight(lambda: _jax_engine(jm), tm.args)
    for (frames, p, m, mf), (jframes, *_r) in zip(got, want):
        np.testing.assert_array_equal(frames, _solo(tm, p, m, mf))
        np.testing.assert_array_equal(frames, jframes)


def _slot_reuse(make, args):
    eng = make()
    reqs = []
    for i, mf in enumerate([3, 7, 2, 5, 4]):
        p, m = _prompt(args, 4 + i, seed=10 + i)
        reqs.append((eng.submit_prompt(p, m, max_frames=mf), p, m, mf))
    eng.run_until_idle()
    assert eng.stats.completed == 5
    assert eng.stats.admissions == 5
    return [(r.wait(0), p, m, mf) for r, p, m, mf in reqs]


def test_slot_reuse_many_requests(models):
    """5 mixed-length requests through 2 slots: every stream recycles a row
    and still gives its solo frames, and the JAX engine's."""
    jm, tm = models
    got = _slot_reuse(lambda: _engine(tm, pipeline_depth=3), tm.args)
    want = _slot_reuse(lambda: _jax_engine(jm, pipeline_depth=3), tm.args)
    for (frames, p, m, mf), (jframes, *_r) in zip(got, want):
        np.testing.assert_array_equal(frames, _solo(tm, p, m, mf))
        np.testing.assert_array_equal(frames, jframes)


def _rebased(make, args):
    eng = make()
    assert eng.capacity == 32 + 8 + 4
    reqs = []
    for i in range(6):
        p, m = _prompt(args, 5 + (i % 3), seed=20 + i)
        reqs.append((eng.submit_prompt(p, m, max_frames=8), p, m))
    eng.run_until_idle()
    assert eng.stats.rebases >= 1
    return [(r.wait(0), p, m) for r, p, m in reqs]


def test_rebase_compaction_parity(models):
    """A deliberately tiny cache: the engine compacts its slots in place
    mid-service; positions are pad-relative, so the frames still equal the
    solo runs and the JAX engine's."""
    jm, tm = models
    kw = dict(max_frames=8, capacity_slack=4)
    got = _rebased(lambda: _engine(tm, **kw), tm.args)
    want = _rebased(lambda: _jax_engine(jm, **kw), tm.args)
    for (frames, p, m), (jframes, *_r) in zip(got, want):
        np.testing.assert_array_equal(frames, _solo(tm, p, m, 8))
        np.testing.assert_array_equal(frames, jframes)


def test_zero_frame_eos_via_sampler(model):
    """A sampler of all-zero frames ends every stream before its first
    step: the admission's EOS path completes it with no frames."""
    def zero_sampler(generator, logits):
        return torch.zeros(logits.shape[:-1], dtype=torch.long)

    eng = _engine(model, sampler=zero_sampler)
    p, m = _prompt(model.args, 5, seed=30)
    r1 = eng.submit_prompt(p, m, max_frames=6)
    r2 = eng.submit_prompt(p, m, max_frames=6)
    eng.run_until_idle()
    assert r1.wait(0).shape[0] == 0
    assert r2.wait(0).shape[0] == 0
    assert eng.stats.completed == 2


def test_max_frames_one_caps_at_admission(model):
    eng = _engine(model)
    p, m = _prompt(model.args, 5, seed=4)
    res = eng.submit_prompt(p, m, max_frames=1)
    eng.run_until_idle()
    got = res.wait(timeout=0)
    assert got.shape[0] == 1
    assert res.finish_reason == "cap"
    np.testing.assert_array_equal(got, _solo(model, p, m, 1))


def test_max_frames_one_with_codec_flushes_chunk(model, fresh_codec):
    """Capped at admission with the codec on: the frame's decode-behind
    chunk (made by the next block) still arrives before the end."""
    eng = _engine(model, n_slots=1, codec=True)
    p, m = _prompt(model.args, 5, seed=5)
    res = eng.submit_prompt(p, m, max_frames=1)
    eng.run_until_idle()
    assert res.wait(0).shape[0] == 1
    assert res.finish_reason == "cap"
    assert res.audio().shape[0] == eng._mimi.frame_size


def test_max_frames_zero_rejected(model):
    eng = _engine(model)
    p, m = _prompt(model.args, 5)
    with pytest.raises(ValueError, match="max_frames"):
        eng.submit_prompt(p, m, max_frames=0)


def test_submit_after_engine_death_raises(model):
    eng = _engine(model)
    eng._dead = RuntimeError("device error")
    p, m = _prompt(model.args, 5)
    with pytest.raises(RuntimeError, match="died"):
        eng.submit_prompt(p, m)


def test_first_chunk_latency_instrumentation(model, fresh_codec):
    eng = _engine(model, n_slots=1, codec=True)
    assert eng.stats.first_chunk_latency_ms()["admit_p50_ms"] is None
    p, m = _prompt(model.args, 5, seed=9)
    res = eng.submit_prompt(p, m, max_frames=2)
    eng.run_until_idle()
    res.wait(0)
    assert res.t_submit is not None
    assert res.t_admitted is not None and res.t_admitted >= res.t_submit
    assert res.t_first_chunk is not None
    assert res.t_first_chunk >= res.t_admitted
    lat = eng.stats.first_chunk_latency_ms()
    assert lat["admit_p50_ms"] is not None and lat["admit_p50_ms"] > 0
    assert lat["submit_p50_ms"] >= lat["admit_p50_ms"]
    assert lat["admit_p99_ms"] >= lat["admit_p90_ms"] >= lat["admit_p50_ms"]
    assert len(eng.stats.admit_to_first_chunk) == 1


def test_audio_and_chunks_consumable_repeatedly(model):
    eng = _engine(model)
    p, m = _prompt(model.args, 5, seed=6)
    res = eng.submit_prompt(p, m, max_frames=2)
    eng.run_until_idle()
    res.wait(0)
    assert list(res.chunks()) == []  # codec off: only the sentinel
    assert res.audio().shape == (0,)
    assert res.audio().shape == (0,)  # and again, without blocking


def test_fail_all_finishes_flush_pending_requests(model):
    eng = _engine(model)
    res = ContinuousResult(4, model.args.n_audio_codebooks)
    slot = eng._slots[0]
    slot.req, slot.prov_req, slot.flush_step = None, res, 3
    eng._fail_all(RuntimeError("stopped"))
    assert res.done.is_set()
    assert slot.flush_step is None
    with pytest.raises(RuntimeError):
        res.wait(0)


def test_fail_all_covers_readmitted_flush_pending(model):
    eng = _engine(model)
    old = ContinuousResult(4, model.args.n_audio_codebooks)
    new = ContinuousResult(4, model.args.n_audio_codebooks)
    admitted = ContinuousResult(4, model.args.n_audio_codebooks)
    slot = eng._slots[0]
    slot.req, slot.prov_req, slot.flush_step = new, new, None
    # `old` rides an unfetched step block; `admitted` an unfetched admit
    eng._inflight.append(("step", ([(old, 3), (None, 0)], 5), None))
    eng._inflight.append(("admit", ([(1, admitted)], 6), None))
    eng._fail_all(RuntimeError("stopped"))
    for res in (old, new, admitted):
        assert res.done.is_set()
        with pytest.raises(RuntimeError):
            res.wait(0)
    assert not eng._inflight


def test_mimi_rebase_keeps_index_bounded(model, fresh_codec):
    """The Mimi ring index moves `downsample_stride` tokens a frame; the
    periodic rebase counts in tokens and keeps it within [2w, 3w)."""
    eng = _engine(model, n_slots=1, codec=True)
    stride = eng._mimi.cfg.downsample_stride
    w = int(eng._dec_state.transformer.window)
    for _epoch in range(3):
        eng._frames_total += eng._MIMI_REBASE_AT
        eng._dec_state.transformer.index.add_(stride * eng._MIMI_REBASE_AT)
        eng._maybe_rebase()
        idx = int(eng._dec_state.transformer.index)
        assert idx == stride * eng._frames_total - eng._mimi_rebased
        assert 2 * w <= idx < 3 * w


def test_capacity_slack_must_cover_step_block(model):
    with pytest.raises(ValueError, match="capacity_slack"):
        _engine(model, capacity_slack=2, frames_per_step=3)


def test_not_ported_options_raise(model):
    """mesh= is ported (tests/test_torch_parallel_serve.py); with the
    whole-frame decoder's tables still in the params it raises, as in JAX
    (`parallel.shard_model` drops them)."""
    model.params["_resident"] = {"layers": []}
    try:
        with pytest.raises(ValueError, match="resident"):
            _engine(model, mesh=object())
    finally:
        model.params.pop("_resident", None)


def test_quantized_codec_engine_close_to_f32(model, fresh_codec):
    """quantize_codec=True (JAX's case): the same greedy tokens, audio that
    differs from the fp32-codec engine's by int8 decode noise alone, and
    the process-wide codec left exact fp32 (its encode and other decodes
    read it): the engine quantizes a private copy of its decoder, which
    shares the encoder's tensors."""
    p, m = _prompt(model.args, 5, seed=6)
    eng_q = _engine(model, n_slots=1, codec=True, quantize_codec=True)
    rq = eng_q.submit_prompt(p, m, max_frames=3)
    eng_q.run_until_idle()
    aq, toks_q = rq.audio(), rq.wait(0)

    eng_f = _engine(model, n_slots=1, codec=True)
    rf = eng_f.submit_prompt(p, m, max_frames=3)
    eng_f.run_until_idle()
    af = rf.audio()

    np.testing.assert_array_equal(toks_q, rf.wait(0))
    assert aq.shape == af.shape
    rel = float(np.sqrt(np.mean((aq - af) ** 2))
                / (np.sqrt(np.mean(af ** 2)) + 1e-12))
    assert 0 < rel < 0.15, rel

    mimi = ttok.get_audio_tokenizer(model.args.n_audio_codebooks,
                                    device="cpu")
    assert eng_f._mimi is mimi and eng_q._mimi is not mimi
    assert "weight_q" not in mimi.params["decoder"]["init"]
    assert "weight_q" in eng_q._mimi.params["decoder"]["init"]
    assert eng_q._mimi.params["encoder"]["init"]["weight"] is \
        mimi.params["encoder"]["init"]["weight"]


@pytest.mark.slow
def test_codec_continuity_on_recycled_row(model, fresh_codec):
    """A stream on a recycled row gives the audio of a fresh batch decode
    of its frames (the ring's per-row start hides its predecessor; the conv
    carries reset)."""
    eng = _engine(model, n_slots=1, codec=True, max_frames=6)
    mimi = eng._mimi
    outs = []
    for i in range(2):  # request 2 recycles request 1's only slot
        p, m = _prompt(model.args, 5, seed=40 + i)
        outs.append(eng.submit_prompt(p, m, max_frames=6))
    eng.run_until_idle()
    for res in outs:
        tokens = res.wait(0)
        assert tokens.shape[0] > 0
        audio = res.audio()
        assert audio.shape[0] == tokens.shape[0] * mimi.frame_size
        ref = mimi.decode(torch.from_numpy(tokens.T[None].copy()))[0, 0]
        ref = ref.numpy()
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(audio, ref, atol=2e-3 * scale)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_random_admissions_and_cancels_match_solo(model, seed):
    """Random prompt lengths, admission times, caps and cancels: every
    completed stream equals its solo run, a cancelled one a prefix of it."""
    rng = np.random.RandomState(100 + seed)
    eng = _engine(model, n_slots=3, max_frames=10, capacity_slack=16,
                  pipeline_depth=2)
    reqs = []
    n_requests = 8
    submitted = 0
    step_budget = 400
    while (submitted < n_requests or eng._active() or eng._flushing()
           or not eng._queue.empty()) and step_budget > 0:
        step_budget -= 1
        if submitted < n_requests and rng.rand() < 0.5:
            s = int(rng.randint(3, 12))
            mf = int(rng.randint(1, 10))
            p, m = _prompt(model.args, s, seed=1000 + submitted + 31 * seed)
            res = eng.submit_prompt(p, m, max_frames=mf)
            reqs.append((res, p, m, mf))
            submitted += 1
            if rng.rand() < 0.2:
                res.cancel()  # sometimes before it is admitted
        if not eng._drive_once() and eng._queue.empty() \
                and submitted >= n_requests:
            break
        if rng.rand() < 0.15 and reqs:
            reqs[int(rng.randint(len(reqs)))][0].cancel()
    eng.run_until_idle()
    assert step_budget > 0, "engine failed to drain within the step budget"
    completed = 0
    for res, p, m, mf in reqs:
        got = res.wait(0)
        if res.finish_reason == "cancel":
            np.testing.assert_array_equal(
                got, _solo(model, p, m, mf)[:got.shape[0]])
            continue
        completed += 1
        np.testing.assert_array_equal(got, _solo(model, p, m, mf))
    assert completed >= 1


def test_result_never_delivers_chunks_after_sentinel():
    res = ContinuousResult(max_frames=8)
    events = []
    res.set_chunk_callback(lambda c: events.append(
        "none" if c is None else "chunk"))
    res._push_chunk(np.zeros(16, np.float32))
    res._finish()
    res._push_chunk(np.zeros(16, np.float32))   # a late in-flight block
    res._finish()                               # idempotent
    assert events == ["chunk", "none"]
    res2 = ContinuousResult(max_frames=8)
    res2._push_chunk(np.zeros(16, np.float32))
    res2._finish()
    res2._push_chunk(np.zeros(16, np.float32))
    assert len(list(res2.chunks())) == 1


def test_result_replay_callback_exception_does_not_strand_chunks():
    res = ContinuousResult(max_frames=8)
    res._push_chunk(np.zeros(16, np.float32))
    res._push_chunk(np.zeros(16, np.float32))
    events = []

    def bad_cb(c):
        events.append("none" if c is None else "chunk")
        raise RuntimeError("consumer bug")

    res.set_chunk_callback(bad_cb)              # must not raise
    assert events == ["chunk", "chunk"]
    assert res._chunks.empty()
    res._finish()
    assert events == ["chunk", "chunk", "none"]


def test_int16_transfer_matches_float32_within_grid(model, fresh_codec):
    p, m = _prompt(model.args, 5, seed=9)
    outs = {}
    for transfer in ("float32", "int16"):
        eng = _engine(model, n_slots=1, codec=True, transfer=transfer)
        res = eng.submit_prompt(p, m, max_frames=4)
        eng.run_until_idle()
        outs[transfer] = (res.token_matrix(), res.audio())
    np.testing.assert_array_equal(outs["float32"][0], outs["int16"][0])
    a, b = outs["float32"][1], outs["int16"][1]
    assert a.shape == b.shape and b.dtype == np.float32
    assert np.abs(np.clip(a, -1.0, 1.0) - b).max() <= 1.0 / 32767.0 + 1e-7


def _bucketed_engine(model, monkeypatch, **kw):
    """Buckets scaled to the tiny model's 512-position window: every 64
    from 64, eager rebase at 48 slots of shift, shrink hysteresis 16."""
    monkeypatch.setattr(
        tcont, "kv_prefix_buckets",
        functools.partial(kv_prefix_buckets, min_capacity=0,
                          start=64, step=64))
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_frames", 200)
    kw.setdefault("capacity_slack", 16)
    kw.setdefault("frames_per_step", 3)
    eng = _engine(model, **kw)
    eng._EAGER_REBASE_SHIFT = 48
    eng._SHRINK_HYSTERESIS = 16
    return eng


def test_kv_bucketed_cache_grow_and_parity(model, monkeypatch):
    """One long stream pushes the index across bucket edges: the blocks
    read growing prefixes of the one buffer, and the frames still equal
    the solo run."""
    eng = _bucketed_engine(model, monkeypatch)
    assert eng.capacity == 32 + 200 + 16
    assert eng._kv_buckets and eng._kv_buckets[-1] == eng.capacity
    assert eng.kv_capacity == 64  # smallest bucket over bootstrap + K
    assert eng._cache.capacity == eng.capacity  # one full-size buffer
    p, m = _prompt(model.args, 6, seed=31)
    res = eng.submit_prompt(p, m, max_frames=150)
    eng.run_until_idle()
    np.testing.assert_array_equal(res.wait(0), _solo(model, p, m, 150))
    assert eng.kv_capacity >= 192
    assert eng.stats.cache_resizes >= 2 and eng.stats.cache_grows >= 2


def test_kv_bucketed_cache_eager_rebase_shrinks(model, monkeypatch):
    """After a long stream ends, the next admissions open a large shift:
    the engine rebases eagerly and shrinks back to the floor bucket, the
    frames exact throughout."""
    eng = _bucketed_engine(model, monkeypatch)
    pa, ma = _prompt(model.args, 6, seed=32)
    ra = eng.submit_prompt(pa, ma, max_frames=150)
    eng.run_until_idle()
    assert eng.kv_capacity >= 192
    rebases0 = eng.stats.rebases
    reqs = []
    for i in range(3):
        p, m = _prompt(model.args, 5 + i, seed=40 + i)
        reqs.append((eng.submit_prompt(p, m, max_frames=6), p, m))
    eng.run_until_idle()
    for res, p, m in reqs:
        np.testing.assert_array_equal(res.wait(0), _solo(model, p, m, 6))
    np.testing.assert_array_equal(ra.wait(0), _solo(model, pa, ma, 150))
    assert eng.stats.rebases > rebases0           # eager, not forced at max
    assert eng._idx + eng.frames_per_step < eng.capacity
    assert eng.kv_capacity == 64                  # back to the floor
    assert eng.stats.cache_resizes > eng.stats.cache_grows  # a shrink


@pytest.mark.parametrize("shift,n", [(3, 40), (64, 200), (100, 150),
                                     (300, 256)])
def test_rebase_shift_equals_a_roll(shift, n):
    """The in-place shift of the live slots equals JAX's roll on them, for
    short shifts (through a bounded staging buffer) and long ones
    (chunks that never overlap)."""
    buf = torch.randn(2, 3, 2, shift + n + 5, 4)
    want = torch.roll(buf, -shift, dims=3)[:, :, :, :n].clone()
    tcont._shift_left(buf, shift, n)
    torch.testing.assert_close(buf[:, :, :, :n], want, rtol=0, atol=0)


@pytest.fixture(scope="module")
def model_d64():
    """A port-only tiny CSM whose backbone has kernel 4's head size (two
    heads of 64 over one kv head) and a random audio_head."""
    from csm_mlx_tpu_torch import config as port_config
    from csm_mlx_tpu_torch.models.csm import CSM, ModelArgs

    port_config.BACKBONE_CONFIGURATION["tiny_d64"] = port_config.LlamaConfig(
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        head_dim=64, intermediate_size=128, hidden_size=128,
        max_position_embeddings=512)
    gen = torch.Generator().manual_seed(11)
    m = CSM(ModelArgs("tiny_d64", "tiny", 256, 64, 8), dtype=torch.float32,
            generator=gen, device="cpu")
    m.params["audio_head"] = torch.randn(m.params["audio_head"].shape,
                                         generator=gen) * 0.5
    return m


def _spy_kernel_4(monkeypatch) -> list:
    """The rows of each call of kernel 4's wrapper from the attention."""
    from csm_mlx_tpu_torch.models import llama

    calls, real = [], llama.flash_decode_sdpa

    def spy(q, *rest):
        calls.append(q.shape[0])
        return real(q, *rest)

    monkeypatch.setattr(llama, "flash_decode_sdpa", spy)
    return calls


@pytest.mark.parametrize("slots,kw,d64,min_b", [
    (8, {}, True, 1),                                   # the default
    (1, {}, True, 1),                                   # at one row
    (8, dict(flash_decode_min_b=None), True, None),     # never
    (8, {}, False, None),                               # head_dim 16
    (8, dict(flash_decode_min_b=8), False, 8),          # explicit: plain
    (7, dict(flash_decode_min_b=8), True, 8),           # under an explicit
])
def test_engine_runs_kernel_4_where_it_takes_the_shape(
        model, model_d64, monkeypatch, slots, kw, d64, min_b):
    """By default each backbone step of every block runs its attention
    through kernel 4 in every layer, at any number of slots, where the
    backbone's head size is 64; with an explicit None or on another head
    size, the masked path. An explicit int keeps its meaning: kernel 4 at
    as many slots or more, on another head size too (on the CPU, kernel
    4's plain version)."""
    m = model_d64 if d64 else model
    calls = _spy_kernel_4(monkeypatch)
    eng = _engine(m, n_slots=slots, **kw)
    res = [eng.submit_prompt(*_prompt(m.args, 4 + i % 3, seed=60 + i),
                             max_frames=5) for i in range(slots)]
    eng.run_until_idle()
    assert all(r.wait(0).shape[0] > 0 for r in res) and eng.stats.steps > 0
    layers = m.args.backbone_config.num_hidden_layers
    runs = min_b is not None and slots >= min_b
    assert len(calls) == (layers * eng.frames_per_step * eng.stats.steps
                          if runs else 0)
    assert set(calls) <= {slots}
    assert eng.flash_decode_min_b == min_b


def test_default_engine_equals_the_masked_engine(model_d64, fresh_codec):
    """At 8 slots the default engine (kernel 4's plain version on the CPU)
    gives the frames and chunks of the engine with `flash_decode_min_b`
    None, more requests than slots."""
    def run(**kw):
        eng = _engine(model_d64, n_slots=8, codec=True, **kw)
        res = [eng.submit_prompt(*_prompt(model_d64.args, 4 + i % 5,
                                          seed=80 + i), max_frames=4 + i)
               for i in range(10)]
        eng.run_until_idle()
        return [(r.wait(0), r.audio()) for r in res], eng

    got, eng = run()
    want, plain = run(flash_decode_min_b=None)
    assert eng.flash_decode_min_b == 1 and plain.flash_decode_min_b is None
    assert eng.stats.steps == plain.stats.steps
    for (frames, audio), (wframes, waudio) in zip(got, want):
        np.testing.assert_array_equal(frames, wframes)
        np.testing.assert_array_equal(audio, waudio)

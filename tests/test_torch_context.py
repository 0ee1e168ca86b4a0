"""PyTorch port vs JAX package: conversational context on the tiny config
(`tiny_args(n_codebooks=8)`), from audio to prompt rows to frames.

One tiny codec (8 quantizers of 32 entries, within the model's audio
vocabulary of 64; SEANet over the real ratios, so a frame is 1,920 samples
as `generate_long`'s budget counts it) is installed in BOTH packages' codec
singletons, the port's seeded random init carried to JAX as numpy; both
use `tests/test_integration.py`'s fake text tokenizer. Then
`tokenize_audio`, `tokenize_segment`, `tokenize_segments_with_loss_mask`
and `_assemble_prompt` give equal rows, and the greedy frames of
`generate(context=...)`, `stream_generate(context=...)`, `generate_batch`
(rows with different contexts) and `generate_long` (its rolling context
trimmed by the token budget) equal JAX's, frame for frame. Waveforms hold
to atol 1e-4 of JAX's decode (`tests/test_torch_mimi_stream.py`'s
tolerance), streamed chunks to rtol 1e-4 / atol 1e-5 (as
`tests/test_torch_stream.py`)."""

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csm_mlx_tpu.config as jconfig
import csm_mlx_tpu.tokenizers as jtok
from conftest import TINY_BACKBONE, tiny_args
from test_integration import FakeTextTokenizer
from test_mimi import TINY
from torch_helpers import to_jax, torch_model_from_jax
from csm_mlx_tpu import generation as jgen
from csm_mlx_tpu.finetune.dataset import CSMDataset as JDataset
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu.models.mimi import Mimi as JMimi
from csm_mlx_tpu.segment import Segment as JSegment
from csm_mlx_tpu_torch import bridge
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch import tokenizers as ttok
from csm_mlx_tpu_torch.finetune.dataset import CSMDataset as TDataset
from csm_mlx_tpu_torch.models.mimi import Mimi as TMimi
from csm_mlx_tpu_torch.models.mimi.mimi import _bucket, mimi_encode_latent
from csm_mlx_tpu_torch.models.mimi.rvq import codebook_embed
from csm_mlx_tpu_torch.segment import Segment as TSegment
from csm_mlx_tpu_torch.utils.audio import write_audio

N_CB = 8
CODEC = dataclasses.replace(TINY, sampling_rate=24000, frame_rate=12.5,
                            upsampling_ratios=(8, 6, 5, 4),
                            num_quantizers=N_CB)
FS = 1920
WAVE_ATOL = 1e-4
# a backbone whose window makes generate_long trim its rolling context
NARROW = dataclasses.replace(TINY_BACKBONE, max_position_embeddings=40)
jconfig.BACKBONE_CONFIGURATION["tiny_ctx_narrow"] = NARROW
bridge.register_llama_configs(backbone={"tiny_ctx_narrow": NARROW})


class _Ids(list):
    """Token ids as a list (JAX's fake) with `.ids` (the port's
    `tokenizers.Tokenizer` encoding)."""

    @property
    def ids(self):
        return list(self)


class FakeTokenizer(FakeTextTokenizer):
    def encode(self, text):
        return _Ids(super().encode(text))


def _jax_model(args, seed):
    jm = jcsm.CSM(args, dtype=jnp.float32, rng=jax.random.PRNGKey(seed))
    jm.params["audio_head"] = jax.random.normal(
        jax.random.PRNGKey(seed + 1), jm.params["audio_head"].shape) * 0.5
    return jm


@pytest.fixture(scope="module")
def models():
    jm = _jax_model(tiny_args(n_codebooks=N_CB), 51)
    return jm, torch_model_from_jax(jm)


@pytest.fixture(scope="module")
def codecs():
    """The port's random init, carried to JAX (`torch_helpers.to_jax`)."""
    tmimi = TMimi(bridge.mimi_config_from(CODEC), device="cpu",
                  generator=torch.Generator().manual_seed(52))
    return JMimi(CODEC, params=to_jax(tmimi.params)), tmimi


@pytest.fixture
def installed(codecs, monkeypatch):
    """The shared codec in both singletons, the fake text tokenizer on
    both sides, and a record of every generate_tokens(_batch) call: (the
    prompt(s), the frames)."""
    jmimi, tmimi = codecs
    monkeypatch.delenv(ttok.MIMI_WEIGHTS_ENV, raising=False)
    monkeypatch.setitem(jtok._MIMI_CACHE, N_CB, (None, jmimi))
    monkeypatch.setitem(ttok._MIMI_CACHE, (N_CB, "cpu"), (None, tmimi))
    fake = FakeTokenizer()
    monkeypatch.setattr(jtok, "get_text_tokenizer", lambda path=None: fake)
    monkeypatch.setattr(ttok, "get_text_tokenizer", lambda path=None: fake)
    calls = {"jax": [], "port": []}
    for side, mod in (("jax", jgen), ("port", tgen)):
        for name in ("generate_tokens", "generate_tokens_batch"):
            def wrapped(*a, _orig=getattr(mod, name), _log=calls[side],
                        **kw):
                out = _orig(*a, **kw)
                _log.append((a[1], np.asarray(out[0]), np.asarray(out[1])))
                return out
            monkeypatch.setattr(mod, name, wrapped)
    return calls


def _wave(frames, seed):
    """A few tones under a slow envelope plus low noise, peak 0.5."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames * FS - 7 * seed) / 24000.0
    x = sum(np.sin(2 * np.pi * f * t + p) for f, p in
            zip(rng.uniform(100, 900, 3), rng.uniform(0, 6, 3)))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t)) \
        + 0.02 * rng.randn(t.size)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def _segments(n):
    texts = ["Hi there.", "Fine, you?", "Okay then."]
    waves = [_wave(3 + i, 60 + i) for i in range(n)]
    return ([JSegment(i % 2, texts[i], waves[i]) for i in range(n)],
            [TSegment(i % 2, texts[i], waves[i]) for i in range(n)])


def _assert_same_calls(calls):
    """Every generate_tokens(_batch) call: the same prompts, the same greedy
    frames and frame counts."""
    assert len(calls["jax"]) == len(calls["port"]) >= 1
    for (jp, jf, jn), (tp, tf, tn) in zip(calls["jax"], calls["port"]):
        for a, b in zip(jp if isinstance(jp, (list, tuple)) else [jp],
                        tp if isinstance(tp, (list, tuple)) else [tp]):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(tf, jf)


def test_tokenize_audio_and_segments_equal_jax(installed, codecs):
    jsegs, tsegs = _segments(3)
    jf, jm = jtok.tokenize_audio(jsegs[0].audio, n_audio_codebooks=N_CB)
    tf, tm = ttok.tokenize_audio(tsegs[0].audio, n_audio_codebooks=N_CB,
                                 mimi=codecs[1])
    assert tf.shape == (4, N_CB + 1) and not tf[-1].any()  # 3 + EOS
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tm, jm)
    with pytest.raises(ValueError, match="mono"):
        ttok.tokenize_audio(np.zeros((2, 100)), n_audio_codebooks=N_CB,
                            mimi=codecs[1])
    for js, ts in zip(jsegs, tsegs):
        want = jtok.tokenize_segment(js, n_audio_codebooks=N_CB)
        got = ttok.tokenize_segment(ts, n_audio_codebooks=N_CB,
                                    mimi=codecs[1])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for max_ms in (None, 1200):
        kw = dict(n_audio_codebooks=N_CB, mask_speaker_ids=[1],
                  max_audio_length_ms=max_ms)
        want = jtok.tokenize_segments_with_loss_mask(jsegs, **kw)
        got = ttok.tokenize_segments_with_loss_mask(tsegs, mimi=codecs[1],
                                                    **kw)
        assert got[2].min() == (0 if max_ms is None else 1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_assemble_prompt_and_generate_with_context_equal_jax(installed,
                                                             models):
    jm, tm = models
    jsegs, tsegs = _segments(2)
    want = jgen._assemble_prompt(jm, "Say it.", 0, jsegs)
    got = tgen._assemble_prompt(tm, "Say it.", 0, tsegs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[0] == 12 + 4 + 12 + 5 + 12  # text, codes, EOS
    jwav = np.asarray(jgen.generate(jm, "Say it.", 0, jsegs, 640,
                                    temperature=0.0))
    twav = tgen.generate(tm, "Say it.", 0, tsegs, 640, temperature=0.0)
    _assert_same_calls(installed)
    assert twav.shape == jwav.shape and twav.shape[0] > 0
    np.testing.assert_allclose(twav.numpy(), jwav, rtol=0, atol=WAVE_ATOL)
    with pytest.raises(NotImplementedError, match="item 6"):
        tgen.generate(tm, "Say it.", 0, tsegs, 640, watermark_key=3)


def test_stream_generate_with_context_equals_jax(installed, models):
    jm, tm = models
    jsegs, tsegs = _segments(2)
    jgen._build_stream_fns.cache_clear()
    try:
        want = np.stack([np.asarray(c) for c in jgen.stream_generate(
            jm, "Go on.", 1, jsegs, 560, temperature=0.0,
            key=jax.random.PRNGKey(0))])
    finally:
        jgen._build_stream_fns.cache_clear()
    got = torch.stack(list(tgen.stream_generate(tm, "Go on.", 1, tsegs, 560,
                                                temperature=0.0)))
    assert got.shape == want.shape and got.shape[1] == FS
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    wav = tgen.generate(tm, "Go on.", 1, tsegs, 560, temperature=0.0)
    np.testing.assert_allclose(got.flatten().numpy(), wav.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_generate_batch_with_contexts_equals_jax(installed, models):
    """Three rows whose contexts hold 0, 1 and 2 segments: one bucket,
    different left pads; each row's frames and its slice of the one Mimi
    decode equal JAX's."""
    jm, tm = models
    jsegs, tsegs = _segments(2)
    texts, speakers = ["One.", "Two, two.", "Three!"], [0, 1, 0]
    want = jgen.generate_batch(jm, texts, speakers,
                               [(), jsegs[:1], jsegs], 480, temperature=0.0)
    got = tgen.generate_batch(tm, texts, speakers, [(), tsegs[:1], tsegs],
                              480, temperature=0.0)
    _assert_same_calls(installed)
    lens = {len(p) for p in installed["port"][0][0]}
    assert len(lens) == 3  # the rows' prompts differ in length
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape and g.shape[0] % FS == 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=WAVE_ATOL)
    with pytest.raises(ValueError, match="lengths differ"):
        tgen.generate_batch(tm, texts, speakers[:2], max_audio_length_ms=240)


def _tie_margin(mimi, audio, frame, codebook):
    """The port's RVQ scores at one (frame, acoustic codebook) of `audio`:
    the gap between the best and the second score, over the largest
    |score| (a tie within fp32 rounding is ~1e-7)."""
    frames = -(-audio.size // FS)
    x = np.zeros((1, 1, _bucket(frames) * FS), np.float32)
    x[0, 0, :audio.size] = audio
    q = mimi.params["quantizer"]
    half, k = ("semantic", 0) if codebook == 0 else ("acoustic",
                                                     codebook - 1)
    latent = mimi_encode_latent(mimi.params, mimi.cfg, torch.from_numpy(x))
    w = q[half]["input_proj"]["weight"]
    residual = torch.einsum("bct,oc->bot", latent,
                            w[:, :, 0] if w.dim() == 3 else w)[0, :, frame]
    for layer in q[half]["layers"][:k + 1]:
        e = codebook_embed(layer["codebook"]).float()
        scores = 2.0 * e @ residual - (e * e).sum(-1)
        residual = residual - e[scores.argmax()]
    top = scores.topk(2).values
    return float((top[0] - top[1]) / scores.abs().max())


def test_generate_long_equals_jax(installed, models, codecs):
    """Three sentences, `rolling_context=2` and a 40-position backbone: the
    rolling context is trimmed by the token budget; every sentence's
    prompt, frames and audio equal JAX's. Each sentence re-encodes the
    audio generated before it (each side its own): where a re-encoded code
    differs, it must be a tie within fp32 rounding, said in a warning, and
    the sentences after it are not compared."""
    jm = _jax_model(dataclasses.replace(tiny_args(n_codebooks=N_CB),
                                        backbone_name="tiny_ctx_narrow"), 53)
    tm = torch_model_from_jax(jm)
    jmimi, tmimi = codecs
    jsegs, tsegs = _segments(1)
    text = "Alpha beta. Gamma delta? Epsilon!"
    kw = dict(rolling_context=2, max_segment_audio_ms=240, temperature=0.0,
              pause_ms=40)
    want = np.asarray(jgen.generate_long(jm, text, 0, jsegs, **kw))
    got = tgen.generate_long(tm, text, 0, tsegs, **kw)
    j_calls, t_calls = installed["jax"], installed["port"]
    assert len(j_calls) == len(t_calls) == 3
    # budget 40 - 3 frames = 37 rows; a segment is 12 text rows + 3 frames
    # + EOS: two context segments and the sentence (44) do not fit, so each
    # sentence keeps one (16 + 12), where rolling_context alone keeps two
    assert [len(c[0]) for c in t_calls] == [28, 28, 28]
    for i, ((jp, jf, jn), (tp, tf, tn)) in enumerate(zip(j_calls, t_calls)):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tf, jf)
        assert tn == jn
        # the piece each side re-encodes for the next sentence's context
        tpiece = tmimi.decode(torch.from_numpy(tf.T[None].copy()))[0, 0]
        jpiece = np.asarray(jmimi.decode(jnp.asarray(jf.T[None])))[0, 0]
        tc = ttok.tokenize_audio(tpiece.numpy(), n_audio_codebooks=N_CB,
                                 mimi=tmimi)[0]
        jc = jtok.tokenize_audio(jpiece, n_audio_codebooks=N_CB)[0]
        if not np.array_equal(tc, jc):
            frame, cb = np.argwhere(tc != jc)[0]
            margin = _tie_margin(tmimi, tpiece.numpy(), frame, cb)
            assert margin < 1e-5, (i, frame, cb, margin)
            warnings.warn(f"sentence {i}: its audio re-encodes to another "
                          f"code at frame {frame}, codebook {cb}, a tie "
                          f"within fp32 rounding (score gap {margin:.1e} of "
                          f"the largest score); later sentences not compared")
            return
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WAVE_ATOL)
    with pytest.raises(ValueError, match="does not fit"):
        tgen.generate_long(tm, "Hello there.", 0, max_segment_audio_ms=3200)
    assert tgen.generate_long(tm, "   ", 0, max_segment_audio_ms=240).shape \
        == (0,)


def test_dataset_tokenizes_json_audio_like_jax(installed, codecs, tmp_path):
    """A JSON conversation whose turns name WAV files: `CSMDataset` reads
    them (`Segment.audio`), encodes them and builds the loss mask as JAX's
    does."""
    items = []
    for i, text in enumerate(["Hello.", "Hi, how are you?"]):
        path = tmp_path / f"turn{i}.wav"
        write_audio(_wave(2 + i, 70 + i), path, 24000)
        items.append({"text": text, "audio_path": str(path), "speaker": i})
    path = tmp_path / "data.json"
    path.write_text(json.dumps([items]))
    kw = dict(n_audio_codebooks=N_CB, mask_speaker_ids=0)
    want = JDataset.from_json(str(path), **kw)[0]
    ds = TDataset.from_json(str(path), mimi=codecs[1], **kw)
    got = ds[0]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2][:12].max() == 0 and got[2][-1].all()
    batch = ds.get_batch([0])
    assert batch["tokens"].shape == (1, 64, N_CB + 1)

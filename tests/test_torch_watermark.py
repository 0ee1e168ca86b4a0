"""PyTorch port vs JAX package: the keyed watermark
(`csm_mlx_tpu_torch/watermark.py`) on the CPU.

The chip matrix and the default payload come from jax.random's threefry,
which the port reproduces in numpy: they must be bit-equal to JAX's (with
its default settings) for several keys and shapes, as must the threefry
pieces under them. The port's embed equals JAX's within 1e-4 of the
signal's peak (two FFT libraries), the port detects its own mark and
payload and not a clean signal or a wrong key, and each package detects
the other's mark. Then `watermark_key` on `generate_batch` and
`generate_long` marks what they return."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_mlx_tpu import watermark as jwm
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch import watermark as twm

KEY = 42
WRONG_KEY = 43
KEYS = (0, 3, KEY, 12345, 2 ** 31 - 1, 2 ** 40 + 5, -1, -77)


def speechlike(seconds: float = 5.0, seed: int = 0) -> np.ndarray:
    """Coloured noise and moving formants (`tests/test_watermark.py`'s)."""
    rng = np.random.RandomState(seed)
    n = int(seconds * twm.SAMPLE_RATE)
    spec = np.fft.rfft(rng.randn(n))
    freqs = np.fft.rfftfreq(n, 1.0 / twm.SAMPLE_RATE)
    x = np.fft.irfft(spec / np.sqrt(1.0 + (freqs / 500.0) ** 2), n=n)
    t = np.arange(n) / twm.SAMPLE_RATE
    for f0 in (220.0, 700.0, 1600.0, 3100.0):
        x += 0.15 * np.sin(2 * np.pi * (f0 + 30 * np.sin(2 * np.pi * 0.7 * t))
                           * t)
    x *= 0.1 / np.sqrt(np.mean(x ** 2))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def clean():
    return speechlike()


@pytest.fixture(scope="module")
def marks(clean):
    """(the port's mark, JAX's mark) of the same signal and key."""
    return (twm.embed_watermark(clean, KEY, device="cpu").numpy(),
            np.asarray(jwm.embed_watermark(clean, KEY)))


@pytest.mark.parametrize("key", KEYS)
def test_threefry_key_fold_in_and_bits_equal_jax(key):
    jk = jax.random.PRNGKey(key)
    tk = twm.prng_key(key)
    np.testing.assert_array_equal(tk, np.asarray(jk))
    for data in (0, 0x5EED, 0xB175, 2 ** 32 - 1):
        np.testing.assert_array_equal(twm.fold_in(tk, data),
                                      np.asarray(jax.random.fold_in(jk, data)))
    for shape in ((1,), (7,), (3, 86), (2, 3, 5)):
        np.testing.assert_array_equal(
            twm.random_bits(tk, shape), np.asarray(jax.random.bits(jk, shape)))
        for p in (0.5, 0.1):
            np.testing.assert_array_equal(
                twm.bernoulli(tk, p, shape),
                np.asarray(jax.random.bernoulli(jk, p, shape)))


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("payload_len", [8, 16, 32])
def test_chips_and_default_payload_equal_jax(key, payload_len):
    np.testing.assert_array_equal(
        twm._chips(twm.prng_key(key), payload_len),
        np.asarray(jwm._chips(jax.random.PRNGKey(key), payload_len)))
    np.testing.assert_array_equal(
        twm.default_payload(key, payload_len),
        np.asarray(jwm.default_payload(key, payload_len)))
    # a raw key array is taken as JAX takes it
    np.testing.assert_array_equal(
        twm.default_payload(twm.prng_key(key), payload_len),
        np.asarray(jwm.default_payload(jax.random.PRNGKey(key), payload_len)))


def test_embed_equals_jax(clean, marks):
    port, jax_mark = marks
    assert port.dtype == np.float32 and port.shape == clean.shape
    np.testing.assert_allclose(port, jax_mark, rtol=0,
                               atol=1e-4 * np.abs(clean).max())
    payload = np.arange(16) % 2
    np.testing.assert_allclose(
        twm.embed_watermark(clean, KEY, payload, device="cpu").numpy(),
        np.asarray(jwm.embed_watermark(clean, KEY, jnp.asarray(payload))),
        rtol=0, atol=1e-4 * np.abs(clean).max())


def test_port_detects_its_own_mark_only(clean, marks):
    port = marks[0]
    hit = twm.detect_watermark(port, KEY, device="cpu")
    assert bool(hit.present) and float(hit.score) > 3.0
    assert bool(twm.check_payload(hit, KEY))
    assert not bool(twm.detect_watermark(port, WRONG_KEY,
                                         device="cpu").present)
    miss = twm.detect_watermark(clean, KEY, device="cpu")
    assert not bool(miss.present) and 0.5 < float(miss.score) < 1.5
    # the detector's numbers are JAX's on the same waveform
    want = jwm.detect_watermark(port, KEY)
    np.testing.assert_allclose(hit.z.numpy(), np.asarray(want.z), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(hit.bits.numpy(), np.asarray(want.bits))
    assert int(hit.shift) == int(want.shift)


def test_each_package_detects_the_others_mark(marks):
    port, jax_mark = marks
    hit = twm.detect_watermark(torch.from_numpy(jax_mark.copy()), KEY)
    assert bool(hit.present) and bool(twm.check_payload(hit, KEY))
    jhit = jwm.detect_watermark(port, KEY)
    assert bool(jhit.present) and bool(jwm.check_payload(jhit, KEY))


def test_survives_gain_noise_trim_and_pcm16(marks):
    port = marks[0]
    rng = np.random.RandomState(1)
    noisy = 0.5 * port + 0.003 * rng.randn(port.size).astype(np.float32)
    pcm = torch.from_numpy(
        np.round(np.clip(noisy, -1, 1) * 32767).astype(np.int16))
    for x in (noisy, pcm, port[5 * twm.HOP:]):
        res = twm.detect_watermark(x, KEY, device="cpu")
        assert bool(res.present) and bool(twm.check_payload(res, KEY))


def test_batch_short_audio_and_bad_payloads(clean):
    batch = np.stack([clean[:48000], clean[48000:96000]])
    marked = twm.embed_watermark(batch, KEY, device="cpu")
    assert marked.shape == batch.shape
    res = twm.detect_watermark(marked, KEY)
    assert res.present.tolist() == [True, True]
    assert twm.check_payload(res, KEY).tolist() == [True, True]
    short = np.zeros(1000, np.float32)
    assert torch.equal(twm.embed_watermark(short, KEY, device="cpu"),
                       torch.from_numpy(short))
    assert not bool(twm.detect_watermark(short, KEY, device="cpu").present)
    with pytest.raises(ValueError, match="shape"):
        twm.embed_watermark(clean, KEY, np.ones(5), device="cpu")
    with pytest.raises(ValueError, match="0/1"):
        twm.embed_watermark(clean, KEY, np.full(16, -1), device="cpu")
    loud = torch.full((48000,), 32767, dtype=torch.int16)
    out = twm.embed_watermark(loud, KEY)
    assert out.dtype == torch.int16 and int(out.min()) > 0  # clipped


def test_an_array_goes_to_cuda_unless_the_cpu_is_asked_for(clean,
                                                          monkeypatch):
    """An array is marked and read on `cuda` by default, which raises
    without a GPU rather than falling back to the CPU; a tensor stays on
    its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        twm.embed_watermark(clean, KEY)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        twm.detect_watermark(clean, KEY)
    x = torch.from_numpy(clean[:8192].copy())
    assert twm.embed_watermark(x, KEY).device == x.device
    assert twm.detect_watermark(x, KEY).bits.device == x.device


class _Codec:
    """A stand-in codec whose decode is a speech-like waveform, so the
    marked and unmarked runs can be compared without a model's audio."""
    frame_size = 1920

    def decode(self, codes):
        b, _, f = codes.shape
        wave = torch.from_numpy(speechlike(f * self.frame_size / 24000))
        return wave.expand(b, 1, -1).clone()


def test_generate_batch_and_long_mark_their_waveforms(monkeypatch):
    """watermark_key on `generate_batch` marks each row, on `generate_long`
    the joined waveform: each output equals the unmarked one through
    `embed_watermark`."""
    def fake_tokens_batch(model, prompts, masks, max_frames, **kw):
        n = len(prompts)
        return np.ones((max_frames, n, 2), np.int32), np.full(n, 12)

    class _Model:
        n_audio_codebooks = 2
        device = torch.device("cpu")

    monkeypatch.setattr(tgen, "generate_tokens_batch", fake_tokens_batch)
    monkeypatch.setattr(tgen, "_assemble_prompt",
                        lambda *a: (np.zeros((3, 3), np.int32),) * 2)
    codec = _Codec()
    plain = tgen.generate_batch(_Model(), ["a", "b"], [0, 1], None, 1200,
                                mimi=codec)
    marked = tgen.generate_batch(_Model(), ["a", "b"], [0, 1], None, 1200,
                                 watermark_key=KEY, mimi=codec)
    for p, m in zip(plain, marked):
        torch.testing.assert_close(m, twm.embed_watermark(p, KEY))
        assert bool(twm.detect_watermark(m, KEY).present)

    def fake_generate(model, sentence, *a, **kw):
        assert kw.get("watermark_key") is None  # marked once, when joined
        return plain[0]

    class _Tok:
        def encode(self, text):
            return type("E", (), {"ids": [1, 2, 3]})()

    import csm_mlx_tpu_torch.tokenizers as ttok

    monkeypatch.setattr(tgen, "generate", fake_generate)
    monkeypatch.setattr(ttok, "get_text_tokenizer", lambda path=None: _Tok())

    class _LongModel(_Model):
        class args:
            class backbone_config:
                max_position_embeddings = 512

    whole = tgen.generate_long(_LongModel(), "One. Two.", 0,
                               max_segment_audio_ms=1200, rolling_context=0)
    marked = tgen.generate_long(_LongModel(), "One. Two.", 0,
                                max_segment_audio_ms=1200, rolling_context=0,
                                watermark_key=KEY)
    torch.testing.assert_close(marked, twm.embed_watermark(whole, KEY))

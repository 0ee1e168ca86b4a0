"""PyTorch port vs JAX package: audio IO (`csm_mlx_tpu_torch/utils/audio.py`,
a copy of `csm_mlx_tpu/utils/audio.py`), on both of its paths: the native
module (`native/audio_native.cpp`, which the port builds into its own
`csm_mlx_tpu_torch/_build/`) and the stdlib `wave` + scipy fallback. Each
read, write and resample must equal the JAX package's, sample for sample
and byte for byte; a malformed file raises in both or reads alike."""

import wave

import numpy as np
import pytest

import csm_mlx_tpu.utils.audio as jaudio
import csm_mlx_tpu_torch.utils.audio as taudio
from csm_mlx_tpu_torch.ops._build import BUILD_DIR


@pytest.fixture(params=["native", "scipy"])
def route(request, monkeypatch):
    """Both modules on the native path, or both on the Python fallback."""
    if request.param == "scipy":
        for mod in (jaudio, taudio):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_lib_tried", True)
    else:
        assert jaudio._native() is not None
        assert taudio._native() is not None
    return request.param


def test_native_module_builds_into_the_port_build_dir():
    lib = taudio._native()
    assert lib is not None
    so = taudio.native_path()
    assert so.parent == BUILD_DIR and so.exists()
    assert BUILD_DIR.parent.name == "csm_mlx_tpu_torch"


def _tone(n, sr, seed=0):
    t = np.arange(n) / sr
    rng = np.random.RandomState(seed)
    return (0.4 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.randn(n)).astype(np.float32)


def test_write_read_equals_jax(route, tmp_path):
    x = _tone(12000, 24000)
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    taudio.write_audio(x, ours, 24000)
    jaudio.write_audio(x, theirs, 24000)
    assert ours.read_bytes() == theirs.read_bytes()
    got = taudio.read_audio(ours, 24000)
    np.testing.assert_array_equal(got, jaudio.read_audio(ours, 24000))
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.abs(got - x).max() < 2.0 / 32768 + 1e-6
    # read with resampling to 16 kHz
    np.testing.assert_array_equal(taudio.read_audio(ours, 16000),
                                  jaudio.read_audio(ours, 16000))


@pytest.mark.parametrize("sr_in,sr_out", [(16000, 24000), (48000, 24000),
                                          (44100, 24000), (24000, 24000)])
def test_resample_equals_jax(route, sr_in, sr_out):
    x = _tone(sr_in // 4, sr_in, seed=sr_in)
    got = taudio.resample(x, sr_in, sr_out)
    np.testing.assert_array_equal(got, jaudio.resample(x, sr_in, sr_out))
    assert got.dtype == np.float32


def _write_pcm(path, data, channels, sr, width):
    scale = 32767.0 if width == 2 else 2147483647.0
    dtype = np.int16 if width == 2 else np.int32
    pcm = (np.clip(data, -1, 1) * scale).astype(dtype)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


@pytest.mark.parametrize("width", [2, 4])
def test_stereo_mixdown_equals_jax(route, tmp_path, width):
    left = _tone(800, 8000, seed=1)
    right = 0.5 * _tone(800, 8000, seed=2)
    inter = np.stack([left, right], axis=1).reshape(-1)
    path = tmp_path / "stereo.wav"
    _write_pcm(path, inter, 2, 8000, width)
    got = taudio.read_audio(path, 8000)
    np.testing.assert_array_equal(got, jaudio.read_audio(path, 8000))
    assert got.shape == (800,)
    np.testing.assert_allclose(got, 0.5 * (left + right), atol=1e-4)


def test_malformed_wavs_equal_jax(route, tmp_path):
    """Truncated, overflowing, garbage and fuzzed files: where the JAX
    package raises, the port raises; where it reads, the port reads the
    same samples. The native parser never crashes the process."""
    good = tmp_path / "good.wav"
    jaudio.write_audio(np.zeros(2400, np.float32), good, 24000)
    blob = bytearray(good.read_bytes())
    cases = {
        "truncated": bytes(blob[:len(blob) // 3]),
        "fmt_len_overflow": bytes(
            blob[:16] + (0x7FFFFFF0).to_bytes(4, "little") + blob[20:40]),
        "garbage": bytes(np.random.RandomState(0).bytes(256)),
        "empty": b"",
        "riff_only": b"RIFF\x00\x00\x00\x00WAVE",
        "chunk_len_wrap": (b"RIFF" + (0x100).to_bytes(4, "little") + b"WAVE"
                           + b"JUNK" + (0xFFFFFFF7).to_bytes(4, "little")
                           + b"\x00" * 64),
    }
    rng = np.random.RandomState(1)
    for i in range(10):
        b = bytearray(blob)
        for _ in range(8):
            b[rng.randint(0, len(b))] = rng.randint(0, 256)
        cases[f"fuzz{i}"] = bytes(b)

    def read(mod, p):
        try:
            return mod.read_audio(p, 24000)
        except Exception as e:  # noqa: BLE001 - compared across packages
            return type(e)

    for name, payload in cases.items():
        p = tmp_path / f"{name}.wav"
        p.write_bytes(payload)
        got, want = read(taudio, p), read(jaudio, p)
        if isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray), name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got is want, (name, got, want)

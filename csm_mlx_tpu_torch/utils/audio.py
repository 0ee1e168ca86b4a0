"""Audio I/O and resampling (copy of `csm_mlx_tpu/utils/audio.py`).

`read_audio(path, sampling_rate)` loads a WAV, mixes it to mono and
resamples it; `write_audio(audio, path, sampling_rate)` writes mono 16-bit
PCM; `resample(audio, sr_in, sr_out)` is a polyphase windowed-sinc
resampler. The work is done by the repository's native module
(`native/audio_native.cpp`: a RIFF parser and writer, the mixdown and the
resampler) through ctypes, with a stdlib `wave` + `scipy.signal.
resample_poly` fallback:

  native .so  ->  stdlib `wave` + scipy.signal.resample_poly

The module is compiled with g++ at first use into the port's build
directory (`csm_mlx_tpu_torch/_build/`, beside the CUDA library), under a
name that carries a hash of the source, so an edited source is rebuilt; a
failed build falls through to the Python path. Host code only: no card
work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from math import gcd
from pathlib import Path
from typing import Optional

import numpy as np

from csm_mlx_tpu_torch.ops._build import BUILD_DIR

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "audio_native.cpp"


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("frames", ctypes.c_int64),
    ]


_lib = None
_lib_tried = False


def native_path() -> Optional[Path]:
    """Where the native module of this source is (or would be) built; None
    without the source."""
    if not NATIVE_SRC.exists():
        return None
    digest = hashlib.sha256(NATIVE_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"_audio_native-{digest}.so"


def _native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        so = native_path()
        if so is None:
            return None
        if not so.exists():
            # compile to a per-process temp name and rename atomically:
            # concurrent first use across processes must never dlopen a
            # half-written .so
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp_so = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp_so, str(NATIVE_SRC)],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp_so, so)
        lib = ctypes.CDLL(str(so))
        f32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.wav_read.argtypes = [ctypes.c_char_p, f32pp,
                                 ctypes.POINTER(_WavInfo)]
        lib.wav_read.restype = ctypes.c_int
        lib.wav_write.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64,
                                  ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_int32]
        lib.wav_write.restype = ctypes.c_int
        lib.mixdown.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32, f32p]
        lib.mixdown.restype = None
        lib.resample_out_len.argtypes = [ctypes.c_int64, ctypes.c_int32,
                                         ctypes.c_int32]
        lib.resample_out_len.restype = ctypes.c_int64
        lib.resample.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                 ctypes.c_int32, f32p]
        lib.resample.restype = ctypes.c_int
        lib.free_buffer.argtypes = [f32p]
        lib.free_buffer.restype = None
        _lib = lib
    except (OSError, subprocess.SubprocessError):
        _lib = None
    return _lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Mono float32 resample."""
    audio = np.ascontiguousarray(
        np.asarray(audio, dtype=np.float32).reshape(-1))
    if sr_in == sr_out:
        return audio
    lib = _native()
    if lib is not None:
        n_out = lib.resample_out_len(len(audio), sr_in, sr_out)
        out = np.empty(int(n_out), dtype=np.float32)
        if lib.resample(_f32p(audio), len(audio), sr_in, sr_out,
                        _f32p(out)) == 0:
            return out
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(audio, sr_out // g, sr_in // g).astype(np.float32)


def read_audio(audio_path, sampling_rate: int = 24000) -> np.ndarray:
    """Read a WAV -> mono mixdown -> resample -> float32 array."""
    path = str(audio_path)
    lib = _native()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_float)()
        info = _WavInfo()
        if lib.wav_read(path.encode(), ctypes.byref(out),
                        ctypes.byref(info)) == 0:
            total = int(info.frames) * int(info.channels)
            data = np.ctypeslib.as_array(out, shape=(total,)).copy()
            lib.free_buffer(out)
            if info.channels > 1:
                # native mixdown (f64 accumulation per frame)
                mono = np.empty(int(info.frames), dtype=np.float32)
                lib.mixdown(_f32p(np.ascontiguousarray(data)),
                            int(info.frames), int(info.channels),
                            _f32p(mono))
                data = mono
            return resample(data, int(info.sample_rate), sampling_rate)
    # stdlib fallback (PCM16/PCM32 WAV only)
    import wave

    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        sw = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sw == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) \
            / 2147483648.0
    else:
        raise ValueError(f"Unsupported WAV sample width {sw} for {path}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return resample(data, sr, sampling_rate)


def write_audio(audio, audio_path, sampling_rate: int = 24000) -> None:
    """Write mono float32 audio to a 16-bit PCM WAV."""
    data = np.ascontiguousarray(np.asarray(audio, dtype=np.float32).reshape(-1))
    path = str(audio_path)
    lib = _native()
    if lib is not None:
        if lib.wav_write(path.encode(), _f32p(data), len(data), 1,
                         sampling_rate, 16) == 0:
            return
    import wave

    pcm = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sampling_rate)
        w.writeframes(pcm.tobytes())

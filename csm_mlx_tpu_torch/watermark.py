"""Keyed spread-spectrum audio watermark (port of `csm_mlx_tpu/watermark.py`).

The scheme is the JAX package's, unchanged: a 1024-point Hann STFT (hop
512) of the 24 kHz waveform; a ±1 chip matrix C[p, b] over `payload_len`
payload slots × the 1–8 kHz band (bins 42..340), constant over blocks of 4
adjacent bins; STFT frame t carries slot t % payload_len, and each in-band
magnitude is multiplied by 1 + strength·s_p·C[p, b] (s_p = ±1, payload
bit p), phase kept, with two magnitude-target projections to survive the
overlap-add. Detection double-centres the log-magnitude, sums the
residual per (slot, bin), correlates it with the chips (an exact null
variance gives z-scores), and takes the best of the payload_len slot
rotations.

The chips and the default payload come from the key through jax.random's
threefry2x32 (`PRNGKey`, `fold_in`, `bernoulli` with partitionable
counters, JAX's default), reproduced here in numpy bit for bit, so a mark
embedded by either package is detected by the other. The STFT runs on
`torch.fft`: a tensor stays on its device, an array goes to `cuda` unless
the caller passes `device="cpu"` (`device.resolve_device`).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from csm_mlx_tpu_torch.device import resolve_device

SAMPLE_RATE = 24_000
FRAME = 1024
HOP = 512
# 1–8 kHz: on the speech formants, clear of the fundamental
BAND_LO = int(1000 * FRAME / SAMPLE_RATE)   # 42
BAND_HI = int(8000 * FRAME / SAMPLE_RATE)   # 341
DEFAULT_PAYLOAD_LEN = 16
DEFAULT_STRENGTH = 0.06
# on the max-over-rotations mean |z|, whose null on unmarked audio is
# about 1.05 ± 0.09 (the JAX package's measurement)
DEFAULT_THRESHOLD = 2.0
BIN_BLOCK = 4      # chips constant over blocks of adjacent bins
EMBED_ITERS = 2    # magnitude-target projection iterations

_M32 = 0xFFFFFFFF


class WatermarkResult(NamedTuple):
    present: torch.Tensor   # bool scalar
    score: torch.Tensor     # mean |z| over payload slots (best rotation)
    bits: torch.Tensor      # (payload_len,) recovered bits, payload order
    z: torch.Tensor         # (payload_len,) z-scores, payload order
    shift: torch.Tensor     # best slot rotation


# -- jax.random's threefry2x32, in numpy --------------------------------------

def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under the
    key (k0, k1), as `jax.random`'s `threefry2x32_p` computes it."""
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(key[0]), np.uint32(key[1])
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        rot = ((13, 15, 26, 6), (17, 29, 16, 24))
        for i in range(5):
            for r in rot[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` with JAX's default 32-bit integers: the
    seed's low 32 bits, behind a zero high word."""
    return np.asarray([0, int(seed) & _M32], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)`."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.asarray([int(data) & _M32], np.uint32))
    return np.asarray([y0[0], y1[0]], np.uint32)


def random_bits(key, shape) -> np.ndarray:
    """`jax.random.bits(key, shape)` (32-bit) with partitionable counters:
    element i draws threefry(key, (hi(i), lo(i))) and xors the two
    words."""
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(_M32)).astype(np.uint32))
    return (y0 ^ y1).reshape(shape)


def bernoulli(key, p: float, shape) -> np.ndarray:
    """`jax.random.bernoulli(key, p, shape)`: a float32 uniform in [0, 1)
    from the top 23 bits of each draw, below p."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    return floats < np.float32(p)


# -- the watermark -------------------------------------------------------------

def _as_key(key: Union[int, np.ndarray]) -> np.ndarray:
    if isinstance(key, (int, np.integer)):
        return prng_key(int(key))
    return np.asarray(key, np.uint32).reshape(2)


def _chips(key, payload_len: int) -> np.ndarray:
    """±1 chip matrix (payload_len, band bins), float32."""
    n_bins = BAND_HI - BAND_LO
    n_cells = -(-n_bins // BIN_BLOCK)
    bern = bernoulli(fold_in(key, 0x5EED), 0.5, (payload_len, n_cells))
    cells = np.where(bern, 1.0, -1.0).astype(np.float32)
    return np.repeat(cells, BIN_BLOCK, axis=1)[:, :n_bins]


def default_payload(key: Union[int, np.ndarray],
                    payload_len: int = DEFAULT_PAYLOAD_LEN) -> np.ndarray:
    """The payload bits derived from the key (int32), used when the caller
    gives none."""
    return bernoulli(fold_in(_as_key(key), 0xB175), 0.5,
                     (payload_len,)).astype(np.int32)


def _frames(n: int, device) -> tuple:
    n_frames = max((n - FRAME) // HOP + 1, 0)
    idx = (torch.arange(n_frames, device=device)[:, None] * HOP
           + torch.arange(FRAME, device=device)[None, :])
    return n_frames, idx


def _window(device) -> torch.Tensor:
    return torch.from_numpy(
        np.hanning(FRAME + 1)[:FRAME].astype(np.float32)).to(device)


def _as_tensor(audio, device) -> torch.Tensor:
    """A tensor on `device` if given; a tensor otherwise stays where it is,
    an array goes to `resolve_device(None)` (`cuda`)."""
    if isinstance(audio, torch.Tensor):
        return audio if device is None else audio.to(device)
    return torch.from_numpy(np.array(audio)).to(resolve_device(device))


def embed_watermark(audio, key: Union[int, np.ndarray],
                    payload=None, *, strength: float = DEFAULT_STRENGTH,
                    payload_len: int = DEFAULT_PAYLOAD_LEN,
                    device=None) -> torch.Tensor:
    """Embed a keyed watermark into a (T,) or (B, T) waveform; returns a
    tensor of the input's dtype on the device the STFT ran on: `device`
    if given, else a tensor's own, else `cuda` for an array. Audio shorter
    than one STFT frame is returned unchanged. `payload`: optional
    (payload_len,) 0/1 bits, by default `default_payload(key)`."""
    if payload is not None:
        payload = np.asarray(payload)
        if payload.shape != (payload_len,):
            raise ValueError(
                f"payload must have shape ({payload_len},) to match "
                f"payload_len; got {payload.shape}")
        if not np.isin(payload, (0, 1)).all():
            raise ValueError("payload bits must be 0/1")
    audio = _as_tensor(audio, device)
    if audio.dim() == 2:
        return torch.stack([embed_watermark(a, key, payload,
                                            strength=strength,
                                            payload_len=payload_len)
                            for a in audio])
    key = _as_key(key)
    n, device = audio.shape[0], audio.device
    n_frames, idx = _frames(n, device)
    if n_frames == 0:
        return audio
    x = audio.float()
    window = _window(device)
    chips = torch.from_numpy(_chips(key, payload_len)).to(device)
    bits = default_payload(key, payload_len) if payload is None else payload
    signs = torch.from_numpy(2 * bits.astype(np.float32) - 1.0).to(device)
    slot = torch.arange(n_frames, device=device) % payload_len
    mod = 1.0 + strength * signs[slot][:, None] * chips[slot]  # (F, bins)
    flat = idx.reshape(-1)
    den = torch.zeros((n,), dtype=torch.float32, device=device).index_add_(
        0, flat, (window * window).expand(n_frames, FRAME).reshape(-1))
    covered = den > 1e-6
    den = torch.where(covered, den, torch.ones_like(den))

    def wola(spec):
        # weighted overlap-add: OLA(w·iSTFT) / OLA(w²) where covered, the
        # input elsewhere (the edges a frame does not reach)
        frames = torch.fft.irfft(spec, n=FRAME, dim=-1) * window
        num = torch.zeros((n,), dtype=torch.float32,
                          device=device).index_add_(0, flat, frames.reshape(-1))
        return torch.where(covered, num / den, x)

    spec = torch.fft.rfft(x[idx] * window, dim=-1)
    target = spec[:, BAND_LO:BAND_HI].abs() * mod
    for it in range(EMBED_ITERS):
        if it:
            spec = torch.fft.rfft(wm[idx] * window, dim=-1)
        band = spec[:, BAND_LO:BAND_HI]
        scale = target / (band.abs() + 1e-12)
        spec = spec.clone()
        spec[:, BAND_LO:BAND_HI] = band * scale
        wm = wola(spec)
    if not audio.dtype.is_floating_point:
        info = torch.iinfo(audio.dtype)
        wm = torch.clamp(torch.round(wm), info.min, info.max)
    return wm.to(audio.dtype)


def detect_watermark(audio, key: Union[int, np.ndarray], *,
                     payload_len: int = DEFAULT_PAYLOAD_LEN,
                     threshold: float = DEFAULT_THRESHOLD,
                     device=None) -> WatermarkResult:
    """Detect and decode a mark embedded with the same key, on `device` as
    `embed_watermark` resolves it; a (B, T) input gives a result of
    stacked rows. `score` is the
    best rotation's mean |z| (its null is near 1.05), `present` whether it
    passes `threshold`."""
    audio = _as_tensor(audio, device)
    if audio.dim() == 2:
        rows = [detect_watermark(a, key, payload_len=payload_len,
                                 threshold=threshold) for a in audio]
        return WatermarkResult(*(torch.stack(f) for f in zip(*rows)))
    key = _as_key(key)
    n, device = audio.shape[0], audio.device
    n_frames, idx = _frames(n, device)
    if n_frames == 0:
        z = torch.zeros((payload_len,), dtype=torch.float32, device=device)
        return WatermarkResult(
            torch.tensor(False, device=device),
            torch.tensor(0.0, device=device),
            torch.zeros((payload_len,), dtype=torch.int32, device=device), z,
            torch.tensor(0, dtype=torch.int32, device=device))
    x = audio.float()
    spec = torch.fft.rfft(x[idx] * _window(device), dim=-1)
    mag = spec[:, BAND_LO:BAND_HI].abs()                  # (F, bins)
    # floor tiny bins against the frame's band peak: silent bins (log -> -inf)
    # must not dominate the correlation
    floor = 1e-3 * mag.amax(dim=1, keepdim=True) + 1e-12
    logm = torch.log(mag + floor)
    logm = logm - logm.mean(dim=0, keepdim=True)
    logm = logm - logm.mean(dim=1, keepdim=True)

    chips = torch.from_numpy(_chips(key, payload_len)).to(device)
    slot = torch.arange(n_frames, device=device) % payload_len
    onehot = torch.nn.functional.one_hot(slot, payload_len).float()  # (F, P)
    agg = onehot.t() @ logm                                # (P, bins)
    n_bins = BAND_HI - BAND_LO
    n_cells = -(-n_bins // BIN_BLOCK)
    cell = torch.nn.functional.pad(
        agg, (0, n_cells * BIN_BLOCK - n_bins)).reshape(
            payload_len, n_cells, BIN_BLOCK).sum(dim=-1)   # (P, cells)
    var = (cell * cell).sum(dim=1)                         # exact null variance
    # rotation search: trimming k frames moves slot (p+k)%P into group p
    zmat = (agg @ chips.t()) / torch.sqrt(var + 1e-12)[:, None]
    p_idx = torch.arange(payload_len, device=device)
    all_z = zmat[p_idx[None, :],
                 (p_idx[None, :] + p_idx[:, None]) % payload_len]
    scores = all_z.abs().mean(dim=1)                       # (rotations,)
    best = torch.argmax(scores)
    score = scores[best]
    z = torch.roll(all_z[best], int(best))
    bits = (z > 0).to(torch.int32)
    return WatermarkResult(score > threshold, score, bits, z,
                           best.to(torch.int32))


def check_payload(result: WatermarkResult, key: Union[int, np.ndarray],
                  payload_len: int = DEFAULT_PAYLOAD_LEN) -> torch.Tensor:
    """True where the recovered bits equal the key's default payload (per
    row of a batched result)."""
    want = torch.from_numpy(default_payload(key, payload_len)).to(
        result.bits.device)
    return (result.bits == want).all(dim=-1)

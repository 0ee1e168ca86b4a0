"""The one traffic generator: requests from a mix's parameters and a seed.

A mix (`traffic/<name>.json`) gives the distributions of prompt and audio
lengths, the share of requests decoded greedily and the share that carry
conversational context. Requests come in blocks of `block`; every block
holds the same sizes (the distribution's quantiles at (i + 0.5) / block)
and the same numbers of greedy and context requests, and the seed only
shuffles them (each attribute on its own) and draws the token contents.
So every seed asks for the same work over any whole number of blocks, in
another order.

Prompts are built here, not tokenized: the card's machine has no text
tokenizer, so a text row is a random text token in the last column (mask
1 there), as `tokenizers.tokenize_text_segment` would lay out real text;
a context segment is its text rows followed by one row per frame of
random audio codes in the 32 audio columns (mask 1 there). A mix with
`context_audio` gives every request of the run the same conversational
context instead: segments of text rows and of seeded audio (white noise
at `audio_std`) that the system encodes itself.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    prompt: np.ndarray  # (S, K+1) int32
    mask: np.ndarray    # (S, K+1) int32
    frames: int         # audio frames the client reads (80 ms each)
    greedy: bool
    context: bool


def _quantiles(dist: dict, n: int) -> np.ndarray:
    """The distribution's values at (i + 0.5) / n, rounded, clipped."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = dist["lo"], dist["hi"]
        v = lo + u * (hi - lo + 1) - 0.5
    elif kind == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        v = dist["median"] * np.exp(dist["sigma"] * z)
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(np.rint(v), dist["lo"], dist["hi"]).astype(np.int64)


def _text_rows(rng, n: int, k: int, n_text: int):
    t = np.zeros((n, k + 1), np.int32)
    m = np.zeros((n, k + 1), np.int32)
    t[:, -1] = rng.integers(0, n_text, size=n)
    m[:, -1] = 1
    return t, m


def _audio_rows(rng, n: int, k: int, n_codes: int):
    t = np.zeros((n, k + 1), np.int32)
    m = np.zeros((n, k + 1), np.int32)
    t[:, :k] = rng.integers(0, n_codes, size=(n, k))
    m[:, :k] = 1
    return t, m


def generate(mix: dict, config: dict, seed: int, n: int,
             stream: int = 0) -> List[Request]:
    """The first `n` requests of the mix under `seed`. `stream` separates
    independent request streams of one run (warm-up, window)."""
    rng = np.random.default_rng([int(seed) % (1 << 64), stream])
    k = config["audio_num_codebooks"]
    n_text = config["text_vocab_size"]
    n_codes = config["mimi"]["codebook_size"]
    block = int(mix["block"])
    prompt_sizes = _quantiles(mix["prompt_rows"], block)
    frame_sizes = _quantiles(mix["frames"], block)
    n_greedy = int(round(block * mix.get("greedy_share", 0.0)))
    ctx: Optional[dict] = mix.get("context")
    n_ctx = int(round(block * ctx["share"])) if ctx else 0
    out: List[Request] = []
    for b0 in range(0, n, block):
        p = rng.permutation(prompt_sizes)
        f = rng.permutation(frame_sizes)
        g = rng.permutation(np.arange(block) < n_greedy)
        c = rng.permutation(np.arange(block) < n_ctx)
        for i in range(min(block, n - b0)):
            parts = []
            if c[i]:
                for seg_frames in ctx["segment_frames"]:
                    lo, hi = ctx["segment_text_rows"]
                    parts.append(_text_rows(rng, int(rng.integers(lo, hi + 1)),
                                            k, n_text))
                    parts.append(_audio_rows(rng, seg_frames, k, n_codes))
                lo, hi = ctx["text_rows"]
                parts.append(_text_rows(rng, int(rng.integers(lo, hi + 1)),
                                        k, n_text))
            else:
                parts.append(_text_rows(rng, int(p[i]), k, n_text))
            out.append(Request(
                index=b0 + i,
                prompt=np.concatenate([t for t, _ in parts]),
                mask=np.concatenate([m for _, m in parts]),
                frames=int(f[i]), greedy=bool(g[i]), context=bool(c[i])))
    return out


def context_audio(mix: dict, config: dict, seed: int) -> list:
    """The run's context segments, [(text rows, mask, audio (T,) float32)],
    or [] for a mix without `context_audio`."""
    spec = mix.get("context_audio")
    if not spec:
        return []
    rng = np.random.default_rng([int(seed) % (1 << 64), 3])
    k, n_text = config["audio_num_codebooks"], config["text_vocab_size"]
    rate = config["mimi"]["sampling_rate"]
    out = []
    for seconds in spec["segment_seconds"]:
        lo, hi = spec["segment_text_rows"]
        rows, mask = _text_rows(rng, int(rng.integers(lo, hi + 1)), k, n_text)
        audio = rng.standard_normal(int(seconds * rate)) * spec["audio_std"]
        out.append((rows, mask, audio.astype(np.float32)))
    return out

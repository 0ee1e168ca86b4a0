"""Samplers and logits processors (port of `csm_mlx_tpu/ops/sampling.py`).

A sampler maps (torch.Generator | None, logits (B, V)) -> tokens (B,) int64;
a processor maps (history (B, H) int64 padded with -1, logits) -> logits.
The surface is the JAX package's: `SamplerConfig` with temperature, top-p,
min-p, top-k and min-tokens-to-keep (temperature scales the logits BEFORE
the filters), `make_sampler`, `RepetitionPenalty`, `LogitBias` and
`make_logits_processors` with its `HISTORY_SIZE` guard.

The JAX package draws with `jax.random.categorical` (the Gumbel-max of the
logits); the port draws the same way from a `torch.Generator`, so greedy
tokens agree with JAX and sampled ones follow the same distribution from
other random bits. Every op runs on the logits' device without reading
anything back to the host, so a sampler can be captured in a CUDA graph
(the generator then registered with the graph).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

# Size of the c0 token-history ring handed to logits processors (JAX's
# HISTORY_SIZE): a processor may not ask for more.
HISTORY_SIZE = 64

NEG_INF = -1e30  # JAX's filtered-logit value

LogitsProcessor = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def _min_p_filter(logits: torch.Tensor, min_p: float,
                  min_tokens_to_keep: int) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    top = probs.max(dim=-1, keepdim=True).values
    keep = probs >= min_p * top
    if min_tokens_to_keep > 1:
        kth = torch.topk(logits, min_tokens_to_keep, dim=-1).values[..., -1:]
        keep = keep | (logits >= kth)
    return torch.where(keep, logits, NEG_INF)


def _top_p_filter(logits: torch.Tensor, top_p: float,
                  min_tokens_to_keep: int) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # A token is in the nucleus if the mass *before* it is still < top_p;
    # the first token is always kept.
    in_nucleus = (cum - probs) < top_p
    keep_n = torch.clamp(in_nucleus.sum(dim=-1, keepdim=True),
                         min=min_tokens_to_keep)
    threshold = torch.gather(sorted_logits, -1, keep_n - 1)
    return torch.where(logits < threshold, NEG_INF, logits)


def categorical(generator: Optional[torch.Generator],
                logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits): the Gumbel-max, as
    `jax.random.categorical` draws. Uniforms in [0, 1) from `generator`."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Greedy at temperature 0; else the logits over the temperature, then
    top-k, min-p and top-p (in that order, each only when set), then a
    categorical draw."""

    temperature: float = 0.8
    top_p: float = 0.0
    min_p: float = 0.0
    top_k: int = 0
    min_tokens_to_keep: int = 1

    def __call__(self, generator: Optional[torch.Generator],
                 logits: torch.Tensor) -> torch.Tensor:
        logits = logits.float()
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        # Temperature scales BEFORE the probability-mass filters, as in JAX
        # and mlx_lm.
        logits = logits / self.temperature
        if self.top_k > 0:
            logits = _top_k_filter(logits, self.top_k)
        if self.min_p > 0.0:
            logits = _min_p_filter(logits, self.min_p,
                                   self.min_tokens_to_keep)
        if 0.0 < self.top_p < 1.0:
            logits = _top_p_filter(logits, self.top_p,
                                   self.min_tokens_to_keep)
        return categorical(generator, logits)


def make_sampler(temp: float = 0.8, top_p: float = 0.0, min_p: float = 0.0,
                 top_k: int = 0, min_tokens_to_keep: int = 1
                 ) -> SamplerConfig:
    """The reference's documented factory (JAX `make_sampler`)."""
    return SamplerConfig(temperature=temp, top_p=top_p, min_p=min_p,
                         top_k=top_k, min_tokens_to_keep=min_tokens_to_keep)


@dataclasses.dataclass(frozen=True)
class RepetitionPenalty:
    """Divide positive / multiply negative logits of recently generated
    tokens by `penalty`. History entries of -1 (padding) are ignored; only
    the most recent `context_size` entries of the ring count."""

    penalty: float = 1.3
    context_size: int = 20

    def __call__(self, history: torch.Tensor,
                 logits: torch.Tensor) -> torch.Tensor:
        if history.dim() == 1:
            history = history[None]
        b, v = logits.shape
        recent = history[:, max(0, history.shape[-1] - self.context_size):]
        # padding lands in a spare column v, dropped after the scatter
        slots = torch.where(recent >= 0, recent, v).long()
        seen = torch.zeros((b, v + 1), dtype=torch.bool,
                           device=logits.device)
        seen = seen.scatter_(1, slots, True)[:, :v]
        penalized = torch.where(logits > 0, logits / self.penalty,
                                logits * self.penalty)
        return torch.where(seen, penalized, logits)


@dataclasses.dataclass(frozen=True)
class LogitBias:
    """Additive per-token bias: ((token, value), ...)."""

    bias: Tuple[Tuple[int, float], ...]

    def __call__(self, history: torch.Tensor,
                 logits: torch.Tensor) -> torch.Tensor:
        # one scalar add per entry: nothing is copied from the host
        logits = logits.clone()
        for token, value in self.bias:
            logits[..., token] += value
        return logits


def make_logits_processors(logit_bias: Optional[dict] = None,
                           repetition_penalty: Optional[float] = None,
                           repetition_context_size: int = 20
                           ) -> Tuple[LogitsProcessor, ...]:
    """The processor chain, as JAX's `make_logits_processors` builds it."""
    processors = []
    if logit_bias:
        processors.append(LogitBias(tuple(sorted(logit_bias.items()))))
    if repetition_penalty and repetition_penalty != 1.0:
        if repetition_context_size > HISTORY_SIZE:
            # the frame loop carries a fixed ring of HISTORY_SIZE entries;
            # a larger window would be silently capped
            raise ValueError(
                f"repetition_context_size={repetition_context_size} exceeds "
                f"the generation loop's history ring (HISTORY_SIZE="
                f"{HISTORY_SIZE})")
        processors.append(RepetitionPenalty(repetition_penalty,
                                            repetition_context_size))
    return tuple(processors)


def apply_processors(processors: Sequence[LogitsProcessor],
                     history: torch.Tensor,
                     logits: torch.Tensor) -> torch.Tensor:
    for proc in processors:
        logits = proc(history, logits)
    return logits

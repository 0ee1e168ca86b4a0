"""Samplers (port of `csm_mlx_tpu/ops/sampling.py`: greedy and plain
temperature).

A sampler maps (torch.Generator | None, logits (B, V)) -> tokens (B,) int64.
The JAX package draws from a `jax.random` key; the port draws from a
`torch.Generator`, so sampled tokens differ between the two for the same
seed (greedy ones do not). top-k, top-p, min-p and the logits processors
(repetition penalty, logit bias) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

# Size of the c0 token-history ring handed to logits processors.
HISTORY_SIZE = 64

LogitsProcessor = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Greedy at temperature 0, else categorical over logits / temperature."""

    temperature: float = 0.8

    def __call__(self, generator: Optional[torch.Generator],
                 logits: torch.Tensor) -> torch.Tensor:
        logits = logits.float()
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]


def apply_processors(processors: Sequence[LogitsProcessor],
                     history: torch.Tensor,
                     logits: torch.Tensor) -> torch.Tensor:
    for proc in processors:
        logits = proc(history, logits)
    return logits

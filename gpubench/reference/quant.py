"""The W8A8 scheme the configurations state, in plain fp32 (and at 4 bits
for the control), shared by every stack of the reference:

- each weight row quantized to int codes in [-lim, lim] with a scale and
  the row's midpoint, w ~= s * q + z (lim 127 for 8 bits, 7 for 4 bits);
- each activation row quantized per call, x ~= (absmax / 127) * xq;
- y = (xq . q) * s * absmax / 127 + z * sum(x).
"""

from __future__ import annotations

from typing import Tuple

import torch


def quant_rows(w: torch.Tensor, bits: int) -> Tuple[torch.Tensor, ...]:
    """(OUT, IN) -> (codes as fp32, s (OUT,), z (OUT,))."""
    lim = 127 if bits == 8 else 7
    w = w.float()
    hi, lo = w.amax(dim=-1), w.amin(dim=-1)
    z = (hi + lo) / 2
    s = torch.clamp((hi - lo) / (2 * lim), min=1e-12)
    q = torch.clamp(torch.round((w - z[:, None]) / s[:, None]), -lim, lim)
    return q, s, z


def quant_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes (as fp32) and absmax / 127."""
    absmax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-6)
    return torch.clamp(torch.round(x * (127.0 / absmax)), -127, 127), \
        absmax / 127.0


class QLinear:
    def __init__(self, w: torch.Tensor, bits: int):
        self.q, self.s, self.z = quant_rows(w, bits)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xq, ax = quant_act(x)
        return (xq @ self.q.t()) * self.s[None] * ax \
            + self.z[None] * x.sum(dim=-1, keepdim=True)

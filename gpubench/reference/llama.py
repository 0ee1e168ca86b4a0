"""Plain fp32 reference of a Llama stack under the W8A8 scheme
(`reference.quant`): CSM-1B's backbone, and CSM's decoder whatever the
backbone is.

Each layer: RMSNorm, grouped-query attention with RoPE over q, k, v and o,
RMSNorm, a SwiGLU MLP over gate, up and down; a final RMSNorm. RoPE is the
Llama-3.1 scaled rotation on interleaved pairs, as the CSM reference
implementation applies it (torchtune's convention). The stack runs one
whole sequence causally, with no cache and no kernel; it imports nothing
of the system under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.reference.quant import QLinear


def rope_freqs(head_dim: int, theta: float, scaling: dict | None
               ) -> np.ndarray:
    """Llama-3.1 inverse frequencies (the wavelength rule), fp32."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2).astype(np.float32)
                             / head_dim))
    if not scaling or scaling.get("rope_type") != "llama3":
        return freqs.astype(np.float32)
    old = float(scaling["original_max_position_embeddings"])
    lo, hi = scaling["low_freq_factor"], scaling["high_freq_factor"]
    wavelen = 2.0 * math.pi / freqs
    smooth = (old / wavelen - lo) / (hi - lo)
    blended = (1.0 - smooth) * freqs / scaling["factor"] + smooth * freqs
    out = np.where(wavelen < old / hi, freqs,
                   np.where(wavelen > old / lo, freqs / scaling["factor"],
                            blended))
    return out.astype(np.float32)


def rope(x: torch.Tensor, cfg: dict, positions: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) rotated at `positions` (S,), interleaved pairs."""
    inv = torch.from_numpy(rope_freqs(cfg["head_dim"], cfg["rope_theta"],
                                      cfg.get("rope_scaling"))).to(x.device)
    ang = positions.float()[:, None] * inv[None]  # (S, D/2)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1).reshape(
        x.shape)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


class Stack:
    """A Llama stack with quantized linears, run over one whole sequence."""

    def __init__(self, p: dict, cfg: dict, bits: int):
        self.cfg = cfg
        self.layers = []
        for lp in p["layers"]:
            at, mlp = lp["self_attn"], lp["mlp"]
            self.layers.append(dict(
                ln1=lp["input_layernorm"]["weight"].float(),
                ln2=lp["post_attention_layernorm"]["weight"].float(),
                **{k: QLinear(at[k]["weight"], bits)
                   for k in ("q_proj", "k_proj", "v_proj", "o_proj")},
                **{k: QLinear(mlp[k]["weight"], bits)
                   for k in ("gate_proj", "up_proj", "down_proj")}))
        self.norm = p["norm"]["weight"].float()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, S, D) fp32, positions 0..S-1, causal -> normed hidden."""
        cfg = self.cfg
        n, s, _ = x.shape
        h, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                      cfg["head_dim"])
        eps = cfg["rms_norm_eps"]
        pos = torch.arange(s, device=x.device)
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=x.device).tril()
        for L in self.layers:
            a = rms_norm(x, L["ln1"], eps).reshape(n * s, -1)
            q = rope(L["q_proj"](a).reshape(n, s, h, hd), cfg, pos)
            k = rope(L["k_proj"](a).reshape(n, s, hkv, hd), cfg, pos)
            v = L["v_proj"](a).reshape(n, s, hkv, hd)
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            k = k.repeat_interleave(h // hkv, dim=1)
            v = v.repeat_interleave(h // hkv, dim=1)
            sc = (q @ k.transpose(-1, -2)) * hd ** -0.5
            sc = sc.masked_fill(~causal, float("-inf"))
            o = (torch.softmax(sc, dim=-1) @ v).transpose(1, 2)
            x = x + L["o_proj"](o.reshape(n * s, h * hd)).reshape(n, s, -1)
            m = rms_norm(x, L["ln2"], eps).reshape(n * s, -1)
            g, u = L["gate_proj"](m), L["up_proj"](m)
            x = x + L["down_proj"](torch.nn.functional.silu(g) * u).reshape(
                n, s, -1)
        return rms_norm(x, self.norm, eps)

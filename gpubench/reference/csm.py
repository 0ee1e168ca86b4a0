"""Plain fp32 reference of CSM under per-channel weight quantization.

Written from the published description of CSM (huggingface.co/sesame/csm-1b:
a Llama backbone over the summed text and audio embeddings of a frame, a
codebook-0 head, and a small Llama decoder that, primed with the backbone's
hidden state and codebook 0's embedding, scores codebooks 1..31 against
per-codebook heads) and of the W8A8 scheme the configuration states:

- each weight row quantized to int codes in [-lim, lim] with a scale and
  the row's midpoint, w ~= s * q + z (lim 127 for 8 bits, 7 for 4 bits);
- each activation row quantized per call, x ~= (absmax / 127) * xq;
- y = (xq . q) * s * absmax / 127 + z * sum(x);
- the audio head rounded to bf16, quantized symmetrically per column,
  scored against the normed hidden state quantized per row.

Everything is fp32 on the device the caller gives, TF32 off (the caller's
`no_tf32`), with no cache, no batching across requests and no kernel: the
backbone runs each request's whole sequence causally, the decoder each
frame's 32 positions. It takes the raw weights (the benchmark's seeded
tree) and works out its own codes; it imports nothing of the system under
test. RoPE is the Llama-3.1 scaled rotation on interleaved pairs, as the
CSM reference implementation applies it (torchtune's convention).
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import numpy as np
import torch


@contextlib.contextmanager
def no_tf32():
    """fp32 matmuls and convolutions in full fp32 for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


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


class Head:
    """A (D, V) audio head: bf16-rounded, symmetric per-column codes."""

    def __init__(self, head: torch.Tensor, bits: int):
        lim = 127 if bits == 8 else 7
        h = head.to(torch.bfloat16).float()
        self.s = torch.clamp(h.abs().amax(dim=0) / lim, min=1e-12)  # (V,)
        self.q = torch.clamp(torch.round(h / self.s[None]), -lim, lim)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xq, ax = quant_act(x)
        return (xq @ self.q) * self.s[None] * ax


class CSMReference:
    """The reference model of a configuration file over a raw weight tree
    (the benchmark's seeded bf16 tree), at `bits` 8 (the configuration)
    or 4 (the control)."""

    def __init__(self, params: dict, config: dict, bits: int = 8):
        self.config = config
        self.v = config["audio_vocab_size"]
        self.k = config["audio_num_codebooks"]
        self.backbone = Stack(params["backbone"], config["backbone"], bits)
        self.decoder = Stack(params["decoder"], config["decoder"], bits)
        self.text = params["text_embeddings"]["weight"]
        self.audio = params["audio_embeddings"]["weight"]
        self.proj = QLinear(params["projection"]["weight"], bits)
        self.c0 = params["codebook0_head"]["weight"].float()
        self.heads = [Head(params["audio_head"][i], bits)
                      for i in range(self.k - 1)]

    def embed_rows(self, tokens: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
        """(S, K+1) frames and masks -> (S, D): the masked sum of the audio
        slots' embeddings and the text slot's."""
        off = torch.arange(self.k, device=tokens.device) * self.v
        audio = self.audio[(tokens[:, :-1] + off).long()].float()
        text = self.text[tokens[:, -1].long()].float()
        m = mask.float()
        return (audio * m[:, :-1, None]).sum(dim=1) + text * m[:, -1:]

    @torch.no_grad()
    def logits(self, prompt: np.ndarray, mask: np.ndarray,
               frames: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
        """Teacher-forced logits of every served token of one request:
        prompt (S, K+1), frames (F, K) -> (c0 (F, V), codebooks 1..K-1
        (F, K-1, V)), fp32."""
        s, f = prompt.shape[0], frames.shape[0]
        tok = torch.from_numpy(np.asarray(prompt, np.int64)).to(device)
        msk = torch.from_numpy(np.asarray(mask, np.int64)).to(device)
        fr = torch.from_numpy(np.asarray(frames, np.int64)).to(device)
        rows = [self.embed_rows(tok, msk)]
        if f > 1:
            ftok = torch.cat([fr[:-1], torch.zeros_like(fr[:-1, :1])], 1)
            fmask = torch.cat([torch.ones_like(fr[:-1]),
                               torch.zeros_like(fr[:-1, :1])], 1)
            rows.append(self.embed_rows(ftok, fmask))
        hidden = self.backbone(torch.cat(rows)[None])[0]  # (S + F - 1, D)
        h = hidden[s - 1:s - 1 + f]  # the states that produced each frame
        c0 = h @ self.c0.t()
        # decoder inputs: [h, emb_0(c0)], then emb_i(c_i) for i = 1..K-2
        off = torch.arange(self.k - 1, device=device) * self.v
        embs = self.audio[(fr[:, :-1] + off).long()].float()  # (F, K-1, D)
        x = torch.cat([h[:, None], embs], dim=1)  # (F, K, D_backbone)
        x = self.proj(x.reshape(f * self.k, -1)).reshape(f, self.k, -1)
        out = self.decoder(x)  # (F, K, D_dec)
        dec = torch.stack([self.heads[i - 1](out[:, i])
                           for i in range(1, self.k)], dim=1)
        return c0, dec[..., :self.v]


def token_gaps(ref: Tuple[torch.Tensor, ...], frames: np.ndarray,
               others: Tuple[torch.Tensor, ...] | None = None
               ) -> torch.Tensor:
    """Per served token, how far its logit lies below the reference's
    best: (F, K). With `others` (another model's logits at the same
    positions), the gap of the token that model puts first instead."""
    c0, dec = ref
    fr = torch.from_numpy(np.asarray(frames, np.int64)).to(c0.device)
    if others is not None:
        fr = torch.cat([others[0].argmax(-1)[:, None],
                        others[1].argmax(-1)], dim=1)
    full = torch.cat([c0[:, None], dec], dim=1)  # (F, K, V)
    picked = full.gather(-1, fr[..., None])[..., 0]
    return full.amax(dim=-1) - picked

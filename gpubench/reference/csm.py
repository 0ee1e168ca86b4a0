"""Plain fp32 reference of CSM under per-channel weight quantization.

Written from the published description of CSM (huggingface.co/sesame/csm-1b:
a backbone over the summed text and audio embeddings of a frame, a
codebook-0 head, and a small Llama decoder that, primed with the backbone's
hidden state and codebook 0's embedding, scores codebooks 1..31 against
per-codebook heads) and of the W8A8 scheme the configuration states
(`reference.quant`), with:

- the audio head rounded to bf16, quantized symmetrically per column,
  scored against the normed hidden state quantized per row.

The backbone is the configuration's architecture's plain stack
(`arch.load(config).reference`; CSM-1B's is `reference.llama.Stack`), the
decoder always `reference.llama.Stack`. Everything is fp32 on the device
the caller gives, TF32 off (the caller's `no_tf32`), with no cache, no
batching across requests and no kernel: the backbone runs each request's
whole sequence causally, the decoder each frame's 32 positions. It takes
the raw weights (the benchmark's seeded tree) and works out its own codes;
it imports nothing of the system under test.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from gpubench import arch
from gpubench.reference.llama import Stack
from gpubench.reference.quant import QLinear, quant_act


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
        self.backbone = arch.load(config).reference(
            params["backbone"], config["backbone"], bits)
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

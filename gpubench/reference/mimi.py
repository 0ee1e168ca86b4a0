"""Plain fp32 reference of Mimi's decoder (codes -> waveform), whole
sequences at once.

A frozen copy of the batch decode path of the port's plain code, with its
JAX-era conventions, from these files (at the commit that added this
benchmark):
- `csm_mlx_tpu_torch/models/mimi/rvq.py`: `codebook_embed`, `_proj`,
  `_nearest`, `rvq_encode`, `split_rvq_encode`, `rvq_decode`,
  `split_rvq_decode`;
- `csm_mlx_tpu_torch/models/mimi/conv.py`: `conv1d`, `conv_transpose1d`,
  `causal_conv_transpose1d` (the float branches only);
- `csm_mlx_tpu_torch/models/mimi/seanet.py`: `_extra_right_pad`,
  `_causal_conv_batch`, `seanet_encode`, `seanet_decode`;
- `csm_mlx_tpu_torch/models/mimi/transformer.py`: `layer_norm`,
  `_rope_half`, the uncached `transformer_forward` with its attention;
- `csm_mlx_tpu_torch/models/mimi/mimi.py`: `mimi_encode_latent`,
  `mimi_encode_fn`, `Mimi.encode`'s padding to a frame bucket,
  `mimi_decode_fn`.
The attention and the linears are written out (softmax of masked scores,
x @ W^T) in place of the port's `sdpa` and `linear`. Imports nothing of
the system under test. The caller runs it in fp32 with TF32 off
(`reference.csm.no_tf32`), except for the control, which turns TF32 on.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]
DILATION_GROWTH = 2
FRAME_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def _codebook(cb: Params) -> torch.Tensor:
    if "embed" in cb:
        return cb["embed"]
    return cb["embed_sum"] / torch.clamp(cb["cluster_usage"], min=1e-5)[:, None]


def _proj(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["weight"]
    if w.dim() == 3:
        w = w[:, :, 0]
    return torch.einsum("bct,oc->bot", x, w.float())


def _rvq_decode(params: Params, codes: torch.Tensor) -> torch.Tensor:
    total = None
    for i, layer in enumerate(params["layers"][:codes.shape[1]]):
        embed = _codebook(layer["codebook"]).float()
        # codes past the codebook (CSM's 2051-entry vocabulary against
        # Mimi's 2048) clamp to its last entry
        q = embed[codes[:, i].clamp(0, embed.shape[0] - 1)]
        total = q if total is None else total + q
    out = total.transpose(1, 2)
    if "output_proj" in params:
        out = _proj(params["output_proj"], out)
    return out


def split_rvq_decode(params: Params, codes: torch.Tensor) -> torch.Tensor:
    n_sem = len(params["semantic"]["layers"])
    out = _rvq_decode(params["semantic"], codes[:, :n_sem])
    if codes.shape[1] > n_sem:
        out = out + _rvq_decode(params["acoustic"], codes[:, n_sem:])
    return out


def _conv1d(p: Params, x, stride=1, dilation=1, groups=1):
    b = p.get("bias")
    return F.conv1d(x, p["weight"].float(), None if b is None else b.float(),
                    stride=stride, dilation=dilation, groups=groups)


def _conv_tr(p: Params, x, stride, groups=1):
    b = p.get("bias")
    full = F.conv_transpose1d(x, p["weight"].float(),
                              None if b is None else b.float(),
                              stride=stride, groups=groups)
    return full[:, :, :x.shape[-1] * stride]


def _extra_right_pad(t: int, kernel: int, stride: int, dilation: int) -> int:
    eff_k = (kernel - 1) * dilation + 1
    pad_total = eff_k - stride
    n_frames = math.ceil((t - eff_k + pad_total) / stride + 1) - 1
    ideal = n_frames * stride + eff_k - pad_total
    return max(ideal - t, 0)


def _causal_conv(p: Params, x, stride=1, dilation=1, mode="constant"):
    k = p["weight"].shape[-1]
    eff_k = (k - 1) * dilation + 1
    right = _extra_right_pad(x.shape[-1], k, stride, dilation)
    return _conv1d(p, F.pad(x, (eff_k - stride, right), mode=mode), stride,
                   dilation)


def seanet_encode(params: Params, ratios, x: torch.Tensor) -> torch.Tensor:
    h = _causal_conv(params["init"], x)
    for stage, ratio in zip(params["stages"], tuple(reversed(ratios))):
        for j, block in enumerate(stage["residual"]):
            r = _causal_conv(block["conv1"], F.elu(h),
                             dilation=DILATION_GROWTH ** j)
            r = _causal_conv(block["conv2"], F.elu(r))
            h = h + r
        h = _causal_conv(stage["down"], F.elu(h), stride=ratio)
    return _causal_conv(params["final"], F.elu(h))


def _rvq_encode(params: Params, x: torch.Tensor, n: int) -> torch.Tensor:
    if "input_proj" in params:
        x = _proj(params["input_proj"], x)
    residual = x.transpose(1, 2)
    codes = []
    for layer in params["layers"][:n]:
        embed = _codebook(layer["codebook"]).float()
        # the nearest entry as the argmax of 2 x.e - |e|^2
        scores = 2.0 * torch.einsum("...d,vd->...v", residual, embed) \
            - torch.sum(embed * embed, dim=-1)
        idx = torch.argmax(scores, dim=-1)
        codes.append(idx)
        residual = residual - embed[idx]
    return torch.stack(codes, dim=1)


def split_rvq_encode(params: Params, x: torch.Tensor, n: int
                     ) -> torch.Tensor:
    n_sem = len(params["semantic"]["layers"])
    codes = [_rvq_encode(params["semantic"], x, n_sem)]
    if n > n_sem:
        codes.append(_rvq_encode(params["acoustic"], x, n - n_sem))
    return torch.cat(codes, dim=1)


@torch.no_grad()
def encode(params: Params, mimi: dict, audio: torch.Tensor) -> torch.Tensor:
    """(B, 1, T) waveform -> (B, K, ceil(T / frame_size)) codes, the
    waveform padded with zeros to whole frames of a bucket."""
    frame = int(mimi["sampling_rate"] / mimi["frame_rate"])
    stride = int(mimi["sampling_rate"] / math.prod(mimi["upsampling_ratios"])
                 / mimi["frame_rate"])
    t = audio.shape[-1]
    frames = -(-t // frame)
    bucket = next((b for b in FRAME_BUCKETS if frames <= b), frames)
    audio = F.pad(audio.float(), (0, bucket * frame - t))
    latent = seanet_encode(params["encoder"], mimi["upsampling_ratios"],
                           audio)
    h = transformer_forward(params["encoder_transformer"], mimi,
                            latent.transpose(1, 2))
    latent = _causal_conv(params["downsample"], h.transpose(1, 2),
                          stride=stride, mode="replicate")
    return split_rvq_encode(params["quantizer"], latent,
                            mimi["num_quantizers"])[:, :, :frames]


def seanet_decode(params: Params, ratios, x: torch.Tensor) -> torch.Tensor:
    h = _causal_conv(params["init"], x)
    for stage, ratio in zip(params["stages"], ratios):
        h = _conv_tr(stage["up"], F.elu(h), stride=ratio)
        for j, block in enumerate(stage["residual"]):
            r = _causal_conv(block["conv1"], F.elu(h),
                             dilation=DILATION_GROWTH ** j)
            r = _causal_conv(block["conv2"], F.elu(r))
            h = h + r
    return _causal_conv(params["final"], F.elu(h))


def _layer_norm(p: Params, x, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).pow(2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["weight"].float() \
        + p["bias"].float()


def _rope_half(x, positions, theta):
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = positions.float()[..., None] * inv
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _lin(p: Params, x):
    return x @ p["weight"].float().t()


def transformer_forward(params: Params, mimi: dict, x: torch.Tensor
                        ) -> torch.Tensor:
    b, s, _ = x.shape
    h, d = mimi["num_attention_heads"], mimi["head_dim"]
    hkv = mimi.get("num_key_value_heads", h)
    eps, theta = mimi.get("norm_eps", 1e-5), mimi.get("rope_theta", 10000.0)
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    qp, kp = torch.arange(s, device=x.device)[:, None], \
        torch.arange(s, device=x.device)[None]
    ok = (kp <= qp) & (kp > qp - mimi["sliding_window"])
    for lp in params["layers"]:
        at = lp["self_attn"]
        a = _layer_norm(lp["input_layernorm"], x, eps)
        q = _rope_half(_lin(at["q_proj"], a).reshape(b, s, h, d), pos, theta)
        k = _rope_half(_lin(at["k_proj"], a).reshape(b, s, hkv, d), pos,
                       theta)
        v = _lin(at["v_proj"], a).reshape(b, s, hkv, d)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        sc = (q @ k.transpose(-1, -2)) * d ** -0.5
        o = torch.softmax(sc.masked_fill(~ok, float("-inf")), dim=-1) @ v
        o = _lin(at["o_proj"], o.transpose(1, 2).reshape(b, s, h * d))
        x = x + o * lp["self_attn_layer_scale"]["scale"].float()
        m = _layer_norm(lp["post_attention_layernorm"], x, eps)
        m = _lin(lp["mlp"]["fc2"], F.gelu(_lin(lp["mlp"]["fc1"], m),
                                         approximate="none"))
        x = x + m * lp["mlp_layer_scale"]["scale"].float()
    return x


@torch.no_grad()
def decode(params: Params, mimi: dict, codes: torch.Tensor) -> torch.Tensor:
    """(B, K, F) codes -> (B, 1, F * frame_size) waveform, fp32."""
    stride = int(mimi["sampling_rate"] / math.prod(mimi["upsampling_ratios"])
                 / mimi["frame_rate"])
    latent = split_rvq_decode(params["quantizer"], codes.long())
    latent = _conv_tr(params["upsample"], latent, stride=stride,
                      groups=mimi.get("upsample_groups", mimi["hidden_size"]))
    h = transformer_forward(params["decoder_transformer"], mimi,
                            latent.transpose(1, 2))
    return seanet_decode(params["decoder"], mimi["upsampling_ratios"],
                         h.transpose(1, 2))

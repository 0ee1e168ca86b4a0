"""Seeded random weights, made on the device in a few large calls.

The benchmark makes the weights itself and hands the same tensors to the
system under test and, regenerated from the same seed after the window, to
the plain reference: neither side's own initializer is used. Every random
leaf of a model is a slice of ONE `torch.randn` buffer drawn from a
`torch.Generator` on the device, in the type the model is served in, then
scaled in place; norms are ones and biases zeros.

The layouts are the checkpoint layouts the port reads (`CSM(args,
params=...)`, `Mimi(cfg, params=...)`): nested dicts of tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from gpubench import arch
from gpubench.arch import llama

# (path, shape, kind, scale): kind "randn" (scaled by `scale`), "ones",
# "zeros" or "full" (filled with `scale`)
Spec = List[Tuple[tuple, tuple, str, float]]


def csm_spec(config: dict) -> Spec:
    """The CSM parameter tree of a configuration file: the backbone's
    leaves from its architecture's file (`arch`), the decoder's Llama
    stack, then the embeddings, the projection and the heads."""
    b, dec = config["backbone"], config["decoder"]
    d_b, d_d = b["hidden_size"], dec["hidden_size"]
    v, k = config["audio_vocab_size"], config["audio_num_codebooks"]
    spec = arch.load(config).spec(("backbone",), b) \
        + llama.spec(("decoder",), dec)
    spec += [
        (("text_embeddings", "weight"), (config["text_vocab_size"], d_b),
         "randn", d_b ** -0.5),
        (("audio_embeddings", "weight"), (v * k, d_b), "randn", d_b ** -0.5),
        (("projection", "weight"), (d_d, d_b), "randn", d_b ** -0.5),
        (("codebook0_head", "weight"), (v, d_b), "randn", d_b ** -0.5),
        # the init zeroes the head; a zero head makes every decoder
        # codebook 0, so it is drawn here
        (("audio_head",), (k - 1, d_d, v), "randn", 0.02),
    ]
    return spec


def mimi_decoder_spec(mimi: dict) -> Spec:
    """The decode direction of Mimi (what decoding reads), with the port's
    initializer's scales: convs N(0, 1/(c_in k)) and zero biases, the
    codec transformer N(0, 1/fan_in) with layer scales 0.01, the RVQ
    codebooks N(0, 1) with unit usage."""
    hid, nf = mimi["hidden_size"], mimi["num_filters"]
    ratios = mimi["upsampling_ratios"]
    spec: Spec = []

    def conv(path, c_out, c_in, k):
        spec.append((path + ("weight",), (c_out, c_in, k), "randn",
                     (c_in * k) ** -0.5))
        spec.append((path + ("bias",), (c_out,), "zeros", 0.0))

    cur = nf * 2 ** len(ratios)
    conv(("decoder", "init"), cur, hid, 7)
    for si, ratio in enumerate(ratios):
        kk = 2 * ratio
        sp = ("decoder", "stages", si)
        spec.append((sp + ("up", "weight"), (cur, cur // 2, kk), "randn",
                     (cur * kk) ** -0.5))
        spec.append((sp + ("up", "bias"), (cur // 2,), "zeros", 0.0))
        hidden = (cur // 2) // 2
        conv(sp + ("residual", 0, "conv1"), hidden, cur // 2, 3)
        conv(sp + ("residual", 0, "conv2"), cur // 2, hidden, 1)
        cur //= 2
    conv(("decoder", "final"), 1, nf, 3)
    spec += _codec_transformer_spec("decoder_transformer", mimi)
    cb, cd = mimi["codebook_size"], mimi["codebook_dim"]
    for part, n in (("semantic", 1), ("acoustic", mimi["num_quantizers"] - 1)):
        qp = ("quantizer", part)
        for j in range(n):
            spec.append((qp + ("layers", j, "codebook", "embed_sum"),
                         (cb, cd), "randn", 1.0))
            spec.append((qp + ("layers", j, "codebook", "cluster_usage"),
                         (cb,), "ones", 1.0))
        spec.append((qp + ("input_proj", "weight"), (cd, hid), "randn",
                     hid ** -0.5))
        spec.append((qp + ("output_proj", "weight"), (hid, cd), "randn",
                     cd ** -0.5))
    spec.append((("upsample", "weight"), (hid, 1, 4), "randn", 4 ** -0.5))
    return spec


def _codec_transformer_spec(name: str, mimi: dict) -> Spec:
    hid = mimi["hidden_size"]
    h, hd = mimi["num_attention_heads"], mimi["head_dim"]
    spec: Spec = []
    for i in range(mimi["num_hidden_layers"]):
        lp = (name, "layers", i)
        for proj in ("q_proj", "k_proj", "v_proj"):
            spec.append((lp + ("self_attn", proj, "weight"), (h * hd, hid),
                         "randn", hid ** -0.5))
        spec.append((lp + ("self_attn", "o_proj", "weight"), (hid, h * hd),
                     "randn", (h * hd) ** -0.5))
        fi = mimi["intermediate_size"]
        spec.append((lp + ("mlp", "fc1", "weight"), (fi, hid), "randn",
                     hid ** -0.5))
        spec.append((lp + ("mlp", "fc2", "weight"), (hid, fi), "randn",
                     fi ** -0.5))
        for norm in ("input_layernorm", "post_attention_layernorm"):
            spec.append((lp + (norm, "weight"), (hid,), "ones", 1.0))
            spec.append((lp + (norm, "bias"), (hid,), "zeros", 0.0))
        for scale in ("self_attn_layer_scale", "mlp_layer_scale"):
            spec.append((lp + (scale, "scale"), (hid,), "full", 0.01))
    return spec


def mimi_encoder_spec(mimi: dict) -> Spec:
    """The encode direction of Mimi (SEANet encoder, its transformer, the
    stride-2 downsample), at the port's initializer's scales."""
    hid, nf = mimi["hidden_size"], mimi["num_filters"]
    spec: Spec = []

    def conv(path, c_out, c_in, k, bias=True):
        spec.append((path + ("weight",), (c_out, c_in, k), "randn",
                     (c_in * k) ** -0.5))
        if bias:
            spec.append((path + ("bias",), (c_out,), "zeros", 0.0))

    conv(("encoder", "init"), nf, 1, 7)
    cur = nf
    for si, ratio in enumerate(reversed(mimi["upsampling_ratios"])):
        sp = ("encoder", "stages", si)
        conv(sp + ("residual", 0, "conv1"), cur // 2, cur, 3)
        conv(sp + ("residual", 0, "conv2"), cur, cur // 2, 1)
        conv(sp + ("down",), cur * 2, cur, 2 * ratio)
        cur *= 2
    conv(("encoder", "final"), hid, cur, 3)
    spec += _codec_transformer_spec("encoder_transformer", mimi)
    conv(("downsample",), hid, hid, 4, bias=False)
    return spec


def _put(tree: Dict[str, Any], path: tuple, value) -> None:
    node: Any = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            if key not in node:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
    if isinstance(path[-1], int):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def make(spec: Spec, seed: int, dtype: torch.dtype,
         device: torch.device) -> Dict[str, Any]:
    """The tree of `spec`: every random leaf a scaled slice of one
    `torch.randn` buffer drawn from a generator on `device` seeded with
    `seed`. The same (spec, seed, dtype, device) gives the same tensors."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sizes = [_numel(shape) for _, shape, kind, _ in spec if kind == "randn"]
    buf = torch.randn((sum(sizes),), generator=gen, dtype=dtype,
                      device=device)
    tree: Dict[str, Any] = {}
    at = 0
    with torch.no_grad():
        for path, shape, kind, scale in spec:
            if kind == "randn":
                n = _numel(shape)
                t = buf[at:at + n].view(shape)
                at += n
                t.mul_(scale)
            elif kind == "ones":
                t = torch.ones(shape, dtype=dtype, device=device)
            elif kind == "zeros":
                t = torch.zeros(shape, dtype=dtype, device=device)
            else:
                t = torch.full(shape, scale, dtype=dtype, device=device)
            _put(tree, path, t)
    return tree


def _numel(shape: tuple) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def csm_params(config: dict, seed: int, device: torch.device,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    return make(csm_spec(config), seed, dtype, device)


def mimi_params(config: dict, seed: int, device: torch.device,
                encoder: bool = False) -> Dict[str, Any]:
    """Mimi's decode-direction weights in fp32, from a seed of their own
    (the CSM seed + 1), and with `encoder` its encode direction's (seed +
    2)."""
    tree = make(mimi_decoder_spec(config["mimi"]), int(seed) + 1,
                torch.float32, device)
    if encoder:
        tree.update(make(mimi_encoder_spec(config["mimi"]), int(seed) + 2,
                         torch.float32, device))
    return tree

"""W8A8 quantization (port of the per-channel half of `csm_mlx_tpu/ops/quant.py`).

Weights: per-output-channel signed int8 codes, w[o,i] ~= s[o] * q[o,i] +
z[o] with z the row midpoint (`quantize_weight_w8`). Activations: each row
dynamically quantized to int8 at every call. The product runs int8 x int8
-> exact int32, then an fp32 affine fix-up.

`w8a8_matvec` is kernel 1 of the port: on CUDA tensors it launches the
hand-written kernel of `csrc/w8a8_matvec.cu`, at ANY number of rows — the
JAX package's split (Pallas kernel at <= 64 rows, its XLA int8 mirror
above) has one arithmetic here, so prefill and decode quantize alike; on
CPU tensors it runs `w8a8_matvec_plain`, the mirror of `_xla_w8a8_matvec`.

Not ported yet: the grouped-affine (MLX) mode, W4A8 and
`quantize_audio_head` (the whole-frame decoder's own int8 head is, in
`ops.resident_decoder.set_resident_audio_head`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_INV_254 = float(np.float32(1.0 / 254.0))
_NO_QUANT = ("layernorm", "norm", "embeddings", "layer_scale", "codebook")


def quantize_weight_w8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(out, in) float -> {"weight_q" int8 (out, in), "scales" (out, 1) fp32,
    "biases" (out, 1) fp32}, equal to the JAX `quantize_weight_w8` under
    `jax.jit`, as `quantize_model` runs it: XLA turns the division by the
    constant 254 into a product with its fp32 reciprocal, so this does too
    (the eager JAX call divides, and its scales may differ in the last bit)."""
    wf = w.float()
    w_max = wf.amax(dim=-1, keepdim=True)
    w_min = wf.amin(dim=-1, keepdim=True)
    z = (w_max + w_min) / 2.0
    s = torch.clamp((w_max - w_min) * _INV_254, min=1e-12)
    q = torch.clamp(torch.round((wf - z) / s), -127, 127).to(torch.int8)
    return {"weight_q": q, "scales": s, "biases": z}


def _int_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact sum_i xq[b,i] * wq[o,i] for int8 operands. On the CPU in int32;
    on CUDA, which has no int32 matmul, in float64 — exact too, since
    |P| <= 127**2 * IN stays far below 2**53."""
    if xq.device.type == "cpu":
        return torch.matmul(xq.int(), wq.int().t())
    return torch.matmul(xq.double(), wq.double().t())


def w8a8_matvec_plain(x: torch.Tensor, weight_q: torch.Tensor,
                      scales: torch.Tensor, biases: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of kernel 1, the mirror of the JAX
    `_xla_w8a8_matvec`. x: (B, IN) -> (B, OUT) in x.dtype."""
    xf = x.float()
    absmax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6)
    # A true division: `127.0 / absmax` would run as reciprocal(absmax) * 127
    # (Tensor.__rtruediv__), one rounding more, which moves some codes.
    xs = torch.full_like(absmax, 127.0) / absmax
    xq = torch.clamp(torch.round(xf * xs), -127, 127).to(torch.int8)
    p = _int_dot(xq, weight_q)
    out_dim = weight_q.shape[0]
    return (p.float() * scales.reshape(1, out_dim) * (absmax / 127.0)
            + biases.reshape(1, out_dim) * xf.sum(dim=-1, keepdim=True)
            ).to(x.dtype)


def w8a8_matvec(x: torch.Tensor, weight_q: torch.Tensor,
                scales: torch.Tensor, biases: torch.Tensor) -> torch.Tensor:
    """Kernel 1: per-row int8 activation quant + int8 x int8 -> int32 dot +
    fp32 fix-up. x: (B, IN) fp32/bf16; weight_q: (OUT, IN) int8; scales,
    biases: (OUT, 1) fp32. On CUDA IN must be a multiple of 16."""
    if x.device.type == "cpu":
        return w8a8_matvec_plain(x, weight_q, scales, biases)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_matvec: unsupported device {x.device}")
    from csm_mlx_tpu_torch.ops import _build

    rows, in_dim = x.shape
    out_dim = weight_q.shape[0]
    if weight_q.shape != (out_dim, in_dim) or weight_q.dtype != torch.int8:
        raise ValueError(f"w8a8_matvec: weight_q {tuple(weight_q.shape)} "
                         f"{weight_q.dtype} does not match x {tuple(x.shape)}")
    if in_dim % 16:
        raise ValueError(f"w8a8_matvec kernel needs IN % 16 == 0, got {in_dim}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"w8a8_matvec: x dtype {x.dtype}; the kernel takes "
                         f"fp32 or bf16")
    for name, t in (("weight_q", weight_q), ("scales", scales),
                    ("biases", biases)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"w8a8_matvec: {name} must be contiguous on "
                             f"{x.device}")
    if weight_q.data_ptr() % 16:
        raise ValueError("w8a8_matvec: weight_q must be 16-byte aligned")
    if scales.dtype != torch.float32 or biases.dtype != torch.float32 \
            or scales.numel() != out_dim or biases.numel() != out_dim:
        raise ValueError("w8a8_matvec: scales/biases must be (OUT, 1) fp32")
    x = x.contiguous()
    qx = torch.empty((rows, in_dim), dtype=torch.int8, device=x.device)
    aux = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    out = torch.empty((rows, out_dim), dtype=x.dtype, device=x.device)
    code = _build.library().csm_w8a8_matvec(
        x.data_ptr(), qx.data_ptr(), aux.data_ptr(), weight_q.data_ptr(),
        scales.data_ptr(), biases.data_ptr(), out.data_ptr(), rows, in_dim,
        out_dim, _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
    _build.check(code, "csm_w8a8_matvec")
    w8a8_matvec.launches += 1
    return out


w8a8_matvec.launches = 0


def audio_head_logits(head: torch.Tensor, i: int,
                      hidden: torch.Tensor) -> torch.Tensor:
    """Logits of codebook i+1: hidden (B, D_dec) x audio_head[i] (D_dec, V),
    in fp32. Only the raw head is ported (its int8 form waits)."""
    if not isinstance(head, torch.Tensor):
        raise ValueError("a quantized audio_head is not ported yet")
    return torch.matmul(hidden.float(), head[i].float())


def quant_linear(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Linear over a W8A8 dict ({"weight_q" int8, "scales", "biases"}); every
    row count goes through `w8a8_matvec`."""
    if params["weight_q"].dtype != torch.int8:
        raise ValueError(f"quant_linear: only W8A8 int8 codes are ported, "
                         f"got {params['weight_q'].dtype}")
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    y = w8a8_matvec(xf, params["weight_q"], params["scales"],
                    params["biases"])
    y = y.reshape(*lead, -1)
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def _quantize_tree(tree: Any, min_size: int, path: str = "") -> Any:
    if isinstance(tree, dict):
        # "codebook" guards RVQ codebooks, not the codebook0_head Linear.
        blocked = any(t in path for t in _NO_QUANT) \
            and "codebook0_head" not in path
        w = tree.get("weight")
        if isinstance(w, torch.Tensor) and w.dim() == 2 and not blocked:
            if w.numel() >= min_size:
                new = {k: v for k, v in tree.items() if k != "weight"}
                new.update(quantize_weight_w8(w))
                return new
            return tree
        return {k: _quantize_tree(v, min_size, f"{path}.{k}")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_quantize_tree(v, min_size, f"{path}.{i}")
                for i, v in enumerate(tree)]
    return tree


def quantize_model(model, min_size: int = 1 << 16, mode: str = "w8a8",
                   targets=("backbone", "decoder", "projection"),
                   fuse: bool = True) -> None:
    """Quantize the large Linear weights of `model.params` in place (W8A8),
    then (with `fuse`) fold q/k/v and gate/up into single wide linears.

    Embeddings, norms and `audio_head` stay as they are, as in the JAX
    package with its default targets. On a CUDA model, W8A8 with `fuse` and
    the decoder among the targets also derives the whole-frame decoder's
    tables (`params["_resident"]`, `ops.resident_decoder`), as the JAX
    package does on any backend but the CPU; generation then runs each
    decoder frame as one kernel-3 launch per chunk of <= 64 rows."""
    if mode != "w8a8":
        raise ValueError(f"quantize_model: mode {mode!r} is not ported yet; "
                         f"only 'w8a8'")
    if "audio_head" in targets:
        raise ValueError("quantize_model: the int8 audio_head is not ported "
                         "yet")
    p = model.params
    for key in targets:
        if key in p:
            p[key] = _quantize_tree(p[key], min_size, path=key)
    if fuse:
        from csm_mlx_tpu_torch.models.llama import fuse_layer_weights

        for key in ("backbone", "decoder"):
            if key in p:
                fuse_layer_weights(p[key])
    if fuse and "decoder" in targets and model.device.type == "cuda":
        from csm_mlx_tpu_torch.ops.resident_decoder import \
            prepare_resident_decoder

        prepare_resident_decoder(model)

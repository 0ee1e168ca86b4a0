"""Quantization (port of `csm_mlx_tpu/ops/quant.py`): grouped affine (MLX
parity) and W8A8.

1. Grouped affine (`quantize_weight`, mode="affine", the default: 4-bit,
   group 64, as the reference's `nn.quantize`). Unsigned codes with
   W ~= scales * q + biases per input group. 8-bit codes are uint8
   (OUT, IN); 4-bit codes are packed two to a byte, uint8 (OUT, IN/2), the
   even column in the low nibble, so that a matvec streams half the bytes.
   `affine_matvec` is kernel 5 of the port: on CUDA tensors it launches the
   hand-written kernel of `csrc/affine_matvec.cu` (any group that is a
   multiple of 16 and divides IN — the JAX Pallas kernel takes only
   128-aligned groups and sends the default group 64 to its dequant einsum);
   on CPU tensors it runs `affine_matvec_plain`. `quant_linear` keeps the
   JAX split on rows: the kernel at <= 64 rows, above that the weight
   dequantized to x.dtype and one `torch.matmul` (JAX's
   `_xla_quant_matmul`).

2. W8A8 (`quantize_weight_w8`, mode="w8a8"): per-output-channel signed int8
   codes, w[o,i] ~= s[o] * q[o,i] + z[o] with z the row midpoint;
   activations dynamically quantized to int8 at every call; the product
   runs int8 x int8 -> exact int32, then an fp32 affine fix-up.
   `w8a8_matvec` is kernel 1 of the port: on CUDA tensors it launches
   `csrc/w8a8_matvec.cu`, at ANY number of rows — the JAX package's split
   (Pallas kernel at <= 64 rows, its XLA int8 mirror above) has one
   arithmetic here, so prefill and decode quantize alike: up to
   W8A8_MATVEC_MAX_ROWS rows the __dp4a matvec, above them a GEMM on the
   int8 tensor cores, with the same exact int32 products; on CPU tensors it
   runs `w8a8_matvec_plain`, the mirror of `_xla_w8a8_matvec`.

3. W4A8 (`quantize_weight_w8(bits=4)`, mode="w4a8"): the same per-channel
   scheme with codes in [-7, 7], stored in int8 carriers as the JAX package
   stores them off the CPU, so they run kernel 1 (and kernel 3) as W8A8
   codes do. W4A8 reads as many bytes as W8A8.

4. The int8 audio head (`quantize_audio_head`, the "audio_head" target in
   W8A8 and W4A8 mode, always 8-bit): (K-1, V_pad, D) per-row codes with the
   vocabulary padded to a multiple of 128, scored by `audio_head_logits`
   through kernel 1 with the pad sliced off. It is not the whole-frame
   decoder's own head (`ops.resident_decoder.set_resident_audio_head`,
   symmetric per column): a model with this head runs the dispatched
   decoder.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from csm_mlx_tpu_torch.ops import launches

DEFAULT_BITS = 4
DEFAULT_GROUP_SIZE = 64
# quant_linear's affine split, as in JAX: the kernel up to this many rows
AFFINE_MAX_ROWS = 64
# kernel 1's route: the matvec up to this many rows, the tensor-core GEMM
# above (kMaxMatvecRows of csrc/w8a8_matvec.cu)
W8A8_MATVEC_MAX_ROWS = 64

# 1 / (2 * limit) of the W8A8 / W4A8 scale as fp32 constants (see
# `quantize_weight_w8`)
_INV_2LIM = {8: float(np.float32(1.0 / 254.0)),
             4: float(np.float32(1.0 / 14.0))}
# 1 / n_levels of the affine codes as fp32 constants: under `jax.jit` XLA
# turns the division by the constant 15 or 255 into a product with its fp32
# reciprocal, and `quantize_model` runs the jitted quantizer
_INV_LEVELS = {4: float(np.float32(1.0 / 15.0)),
               8: float(np.float32(1.0 / 255.0))}
_NO_QUANT = ("layernorm", "norm", "embeddings", "layer_scale", "codebook")
# the per-channel modes and their code width
_PER_CHANNEL = {"w8a8": 8, "w4a8": 4}


# --- grouped affine ----------------------------------------------------------


def pack_uint4(q: torch.Tensor) -> torch.Tensor:
    """(OUT, IN) codes 0..15 -> uint8 (OUT, IN/2), column 2j in the low
    nibble of byte j and column 2j+1 in its high nibble."""
    q = q.to(torch.uint8)
    return (q[:, 0::2] | (q[:, 1::2] << 4)).contiguous()


def unpack_uint4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (OUT, IN/2) -> uint8 (OUT, IN) codes 0..15 (`pack_uint4`'s
    inverse)."""
    return torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(
        packed.shape[0], -1)


def code_bits(weight_q: torch.Tensor, in_dim: int) -> int:
    """The width of affine codes, read from their stored shape against the
    input width: 8 for (OUT, IN), 4 for packed (OUT, IN/2)."""
    if weight_q.dtype != torch.uint8:
        raise ValueError(f"affine codes are uint8, got {weight_q.dtype}")
    if weight_q.shape[1] == in_dim:
        return 8
    if 2 * weight_q.shape[1] == in_dim:
        return 4
    raise ValueError(f"affine codes {tuple(weight_q.shape)} fit neither "
                     f"8-bit nor packed 4-bit codes of IN={in_dim}")


def quantize_weight(w: torch.Tensor, bits: int = DEFAULT_BITS,
                    group_size: int = DEFAULT_GROUP_SIZE
                    ) -> Dict[str, torch.Tensor]:
    """(out, in) float -> {"weight_q" uint8, "scales" (out, n_groups) fp32,
    "biases" (out, n_groups) fp32 (= each group's min)}: 8-bit codes
    (out, in), 4-bit codes packed (out, in/2). Equal to the JAX
    `quantize_weight` under `jax.jit`, as `quantize_model` runs it (see
    `_INV_LEVELS`)."""
    if bits not in _INV_LEVELS:
        raise ValueError(f"quantize_weight: bits {bits}; 4 or 8")
    out_dim, in_dim = w.shape
    if in_dim % group_size:
        raise ValueError(f"quantize_weight: IN {in_dim} is not a multiple "
                         f"of group_size {group_size}")
    n_levels = (1 << bits) - 1
    wf = w.float().reshape(out_dim, in_dim // group_size, group_size)
    w_max = wf.amax(dim=-1)
    w_min = wf.amin(dim=-1)
    scale = (w_max - w_min) * _INV_LEVELS[bits]
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round((wf - w_min[..., None]) / scale[..., None]),
                    0, n_levels).to(torch.uint8).reshape(out_dim, in_dim)
    if bits == 4:
        q = pack_uint4(q)
    return {"weight_q": q, "scales": scale, "biases": w_min}


def dequantize_weight(qp: Dict[str, torch.Tensor], bits: int,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """An affine dict -> the (out, in) weight s * q + z in fp32, cast to
    `dtype`. `bits` is required: uint8 (out, n) codes may be 8-bit codes of
    IN = n or packed 4-bit codes of IN = 2n (the JAX dict tells them apart
    by its uint4 dtype; the port's does not)."""
    q = qp["weight_q"]
    if bits == 4:
        q = unpack_uint4(q)
    elif bits != 8:
        raise ValueError(f"dequantize_weight: bits {bits}; 4 or 8")
    out_dim, in_dim = q.shape
    n_groups = qp["scales"].shape[-1]
    qf = q.reshape(out_dim, n_groups, in_dim // n_groups).float()
    w = qf * qp["scales"][..., None] + qp["biases"][..., None]
    return w.reshape(out_dim, in_dim).to(dtype)


def affine_matvec_plain(x: torch.Tensor, weight_q: torch.Tensor,
                        scales: torch.Tensor, biases: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version of kernel 5, the arithmetic of the JAX
    `_pallas_quant_matvec`: the weight dequantized in fp32, an fp32 product,
    the output in x.dtype. x: (B, IN) -> (B, OUT)."""
    w = dequantize_weight({"weight_q": weight_q, "scales": scales,
                           "biases": biases},
                          code_bits(weight_q, x.shape[-1]), torch.float32)
    return torch.matmul(x.float(), w.t()).to(x.dtype)


def affine_matvec(x: torch.Tensor, weight_q: torch.Tensor,
                  scales: torch.Tensor, biases: torch.Tensor) -> torch.Tensor:
    """Kernel 5: grouped-affine dequant matvec, fp32 accumulation. x:
    (B, IN) fp32/bf16; weight_q: uint8 (OUT, IN) 8-bit or (OUT, IN/2)
    packed 4-bit codes; scales, biases: (OUT, IN/group) fp32. On CUDA the
    group must be a multiple of 16. Returns (B, OUT) in x.dtype."""
    if x.device.type == "cpu":
        return affine_matvec_plain(x, weight_q, scales, biases)
    if x.device.type != "cuda":
        raise ValueError(f"affine_matvec: unsupported device {x.device}")
    from csm_mlx_tpu_torch.ops import _build

    rows, in_dim = x.shape
    out_dim, n_groups = scales.shape
    bits = code_bits(weight_q, in_dim)
    if weight_q.shape[0] != out_dim or biases.shape != scales.shape:
        raise ValueError(f"affine_matvec: codes {tuple(weight_q.shape)}, "
                         f"scales {tuple(scales.shape)} and biases "
                         f"{tuple(biases.shape)} do not match")
    group = in_dim // n_groups
    if in_dim % n_groups or group % 16:
        raise ValueError(f"affine_matvec kernel needs a group that is a "
                         f"multiple of 16 and divides IN; got IN={in_dim}, "
                         f"{n_groups} groups")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"affine_matvec: x dtype {x.dtype}; the kernel "
                         f"takes fp32 or bf16")
    for name, t in (("weight_q", weight_q), ("scales", scales),
                    ("biases", biases)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"affine_matvec: {name} must be contiguous on "
                             f"{x.device}")
    if scales.dtype != torch.float32 or biases.dtype != torch.float32:
        raise ValueError("affine_matvec: scales/biases must be fp32")
    x = x.contiguous()
    if weight_q.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("affine_matvec: weight_q and x must be 16-byte "
                         "aligned")
    out = torch.empty((rows, out_dim), dtype=x.dtype, device=x.device)
    code = _build.library().csm_affine_matvec(
        x.data_ptr(), weight_q.data_ptr(), scales.data_ptr(),
        biases.data_ptr(), out.data_ptr(), rows, in_dim, out_dim, group,
        bits, _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
    _build.check(code, "csm_affine_matvec")
    affine_matvec.launches += 1
    return out


launches.register(affine_matvec)


# --- W8A8 --------------------------------------------------------------------


def quantize_weight_w8(w: torch.Tensor, bits: int = 8
                       ) -> Dict[str, torch.Tensor]:
    """(..., out, in) float -> {"weight_q" int8 (..., out, in), "scales"
    (..., out, 1) fp32, "biases" (..., out, 1) fp32}: per-row signed codes
    in [-127, 127] (bits=8, W8A8) or [-7, 7] (bits=4, W4A8, still in int8
    carriers), w ~= s * q + z with z the row midpoint. Equal to the JAX
    `quantize_weight_w8` under `jax.jit`, as `quantize_model` runs it: XLA
    turns the division by the constant 2 * limit into a product with its
    fp32 reciprocal, so this does too (the eager JAX call divides, and its
    scales may differ in the last bit)."""
    if bits not in _INV_2LIM:
        raise ValueError(f"quantize_weight_w8: bits {bits}; 4 or 8")
    lim = 127 if bits == 8 else 7
    wf = w.float()
    w_max = wf.amax(dim=-1, keepdim=True)
    w_min = wf.amin(dim=-1, keepdim=True)
    z = (w_max + w_min) / 2.0
    s = torch.clamp((w_max - w_min) * _INV_2LIM[bits], min=1e-12)
    q = torch.clamp(torch.round((wf - z) / s), -lim, lim).to(torch.int8)
    return {"weight_q": q, "scales": s, "biases": z}


def quantize_audio_head(audio_head: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The (K-1, D, V) audio head -> {"weight_q" int8 (K-1, V_pad, D),
    "scales", "biases" fp32 (K-1, V_pad, 1)}: each head transposed to the
    matvec's (OUT, IN) orientation, V zero-padded to V_pad = ceil(V / 128)
    * 128 and quantized per row in 8 bits, as the JAX function does. Each
    tensor is contiguous, so `weight_q[i]` is a (V_pad, D) view on a
    16-byte boundary (D % 16 == 0) that kernel 1 takes as it is."""
    v = audio_head.shape[-1]
    v_pad = -(-v // 128) * 128
    with torch.no_grad():
        wt = F.pad(audio_head.float().transpose(1, 2), (0, 0, 0, v_pad - v))
        q = quantize_weight_w8(wt, bits=8)
    return {k: t.contiguous() for k, t in q.items()}


def _int_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact sum_i xq[b,i] * wq[o,i] for int8 operands. On the CPU in int32;
    on CUDA, which has no int32 matmul, in float64 — exact too, since
    |P| <= 127**2 * IN stays far below 2**53."""
    if xq.device.type == "cpu":
        return torch.matmul(xq.int(), wq.int().t())
    return torch.matmul(xq.double(), wq.double().t())


def w8a8_quant_rows_plain(x: torch.Tensor
                          ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Plain version of kernel 1's row quantization: x (B, IN) -> (qx int8
    (B, IN), aux fp32 (B, 2) = (absmax / 127, the row's sum))."""
    xf = x.float()
    absmax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6)
    # A true division: `127.0 / absmax` would run as reciprocal(absmax) * 127
    # (Tensor.__rtruediv__), one rounding more, which moves some codes.
    xs = torch.full_like(absmax, 127.0) / absmax
    xq = torch.clamp(torch.round(xf * xs), -127, 127).to(torch.int8)
    return xq, torch.cat([absmax / 127.0, xf.sum(dim=-1, keepdim=True)], 1)


def w8a8_partial_plain(xq: torch.Tensor, lo: int, weight_q: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version of kernel 1's int32 partial: columns [lo, lo + IN) of
    the codes xq against weight_q (OUT, IN) -> exact int32 (B, OUT)."""
    return _int_dot(xq[:, lo:lo + weight_q.shape[1]], weight_q).to(
        torch.int32)


def w8a8_fixup_plain(p: torch.Tensor, aux: torch.Tensor,
                     scales: torch.Tensor, biases: torch.Tensor, dtype
                     ) -> torch.Tensor:
    """Plain version of kernel 1's fix-up: p * s * aux.x + z * aux.y in
    fp32, cast to `dtype`."""
    out_dim = scales.numel()
    return (p.float() * scales.reshape(1, out_dim) * aux[:, :1]
            + biases.reshape(1, out_dim) * aux[:, 1:]).to(dtype)


def w8a8_matvec_plain(x: torch.Tensor, weight_q: torch.Tensor,
                      scales: torch.Tensor, biases: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of kernel 1, the mirror of the JAX
    `_xla_w8a8_matvec`. x: (B, IN) -> (B, OUT) in x.dtype."""
    xq, aux = w8a8_quant_rows_plain(x)
    return w8a8_fixup_plain(_int_dot(xq, weight_q), aux, scales, biases,
                            x.dtype)


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
    if rows > W8A8_MATVEC_MAX_ROWS:
        w8a8_matvec.gemm_launches += 1
    return out


launches.register(w8a8_matvec)
# the launches above that took the tensor-core GEMM (rows > 64)
launches.register(w8a8_matvec, "gemm_launches", "w8a8_matvec.gemm")


def _lib_device(name: str, *tensors: torch.Tensor):
    """The kernel library for tensors that must share one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous on "
                             f"{dev}")
    from csm_mlx_tpu_torch.ops import _build

    return _build, dev


def w8a8_quant_rows(x: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Kernel 1's row quantization alone (the tensor-parallel in-sharded
    linear quantizes the whole gathered row once): x (B, IN) fp32/bf16 ->
    (qx int8 (B, IN), aux fp32 (B, 2)), bit-equal to what the fused call
    computes. IN % 16 == 0 on CUDA."""
    if x.device.type == "cpu":
        return w8a8_quant_rows_plain(x)
    x = x.contiguous()
    _build, dev = _lib_device("w8a8_quant_rows", x)
    rows, in_dim = x.shape
    if in_dim % 16 or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"w8a8_quant_rows takes fp32/bf16 rows with "
                         f"IN % 16 == 0, got {x.dtype} {tuple(x.shape)}")
    qx = torch.empty((rows, in_dim), dtype=torch.int8, device=dev)
    aux = torch.empty((rows, 2), dtype=torch.float32, device=dev)
    if rows:
        _build.check(_build.library().csm_w8a8_quant_rows(
            x.data_ptr(), qx.data_ptr(), aux.data_ptr(), rows, in_dim,
            _build.DTYPE_CODES[x.dtype], _build.stream_ptr(dev)),
            "csm_w8a8_quant_rows")
        w8a8_quant_rows.launches += 1
    return qx, aux


def w8a8_partial(xq: torch.Tensor, lo: int, weight_q: torch.Tensor
                 ) -> torch.Tensor:
    """Kernel 1's int32 partial: the raw sums of columns [lo, lo + IN) of
    the codes xq (B, IN_total) int8 against this rank's shard weight_q
    (OUT, IN) int8 -> int32 (B, OUT), no fix-up; the matvec up to 64 rows,
    the tensor-core GEMM above. On CUDA lo, IN and IN_total are multiples
    of 16."""
    if xq.device.type == "cpu":
        return w8a8_partial_plain(xq, lo, weight_q)
    _build, dev = _lib_device("w8a8_partial", xq, weight_q)
    rows, ldx = xq.shape
    out_dim, in_dim = weight_q.shape
    if xq.dtype != torch.int8 or weight_q.dtype != torch.int8 \
            or lo % 16 or in_dim % 16 or ldx % 16 or lo + in_dim > ldx:
        raise ValueError(f"w8a8_partial: int8 codes {tuple(xq.shape)}, "
                         f"columns [{lo}, {lo + in_dim}), shard "
                         f"{tuple(weight_q.shape)}: need int8 and offsets "
                         f"and widths that are multiples of 16")
    if xq.data_ptr() % 16 or weight_q.data_ptr() % 16:
        raise ValueError("w8a8_partial: codes and shard must be 16-byte "
                         "aligned")
    out = torch.empty((rows, out_dim), dtype=torch.int32, device=dev)
    if rows:
        _build.check(_build.library().csm_w8a8_partial(
            xq.data_ptr() + lo, ldx, weight_q.data_ptr(), out.data_ptr(),
            rows, in_dim, out_dim, _build.stream_ptr(dev)),
            "csm_w8a8_partial")
        w8a8_partial.launches += 1
    return out


def w8a8_fixup(p: torch.Tensor, aux: torch.Tensor, scales: torch.Tensor,
               biases: torch.Tensor, dtype) -> torch.Tensor:
    """Kernel 1's fix-up on summed int32 partials: p (B, OUT) int32, aux
    (B, 2) fp32 from `w8a8_quant_rows`, scales/biases (OUT, 1) fp32 ->
    (B, OUT) in `dtype` (fp32 or bf16)."""
    if p.device.type == "cpu":
        return w8a8_fixup_plain(p, aux, scales, biases, dtype)
    _build, dev = _lib_device("w8a8_fixup", p, aux, scales, biases)
    rows, out_dim = p.shape
    if p.dtype != torch.int32 or aux.shape != (rows, 2) \
            or scales.numel() != out_dim or biases.numel() != out_dim \
            or dtype not in _build.DTYPE_CODES:
        raise ValueError(f"w8a8_fixup: int32 sums {tuple(p.shape)} "
                         f"{p.dtype}, aux {tuple(aux.shape)}, {dtype}")
    out = torch.empty((rows, out_dim), dtype=dtype, device=dev)
    if rows:
        _build.check(_build.library().csm_w8a8_fixup(
            p.data_ptr(), aux.data_ptr(), scales.data_ptr(),
            biases.data_ptr(), out.data_ptr(), rows, out_dim,
            _build.DTYPE_CODES[dtype], _build.stream_ptr(dev)),
            "csm_w8a8_fixup")
        w8a8_fixup.launches += 1
    return out


launches.register(w8a8_quant_rows)
launches.register(w8a8_partial)
launches.register(w8a8_fixup)


def audio_head_logits(head, i: int, hidden: torch.Tensor,
                      n_vocab: int) -> torch.Tensor:
    """Logits of codebook i+1, (B, V) fp32, from hidden (B, D_dec): against
    the raw (K-1, D_dec, V) head in fp32, or against head i of
    `quantize_audio_head`'s dict through kernel 1 (`quant_linear`) over the
    padded vocabulary, the pad sliced off (`n_vocab` = V). Under a sharded
    model's tensor parallelism the raw head holds this rank's block of the
    vocabulary where V divides the model axis (JAX's rules): its local
    logits are all-gathered; the dict stays whole, as in JAX."""
    if isinstance(head, dict):
        y = quant_linear({"weight_q": head["weight_q"][i],
                          "scales": head["scales"][i],
                          "biases": head["biases"][i]}, hidden).float()
        return y[:, :n_vocab]
    from csm_mlx_tpu_torch.ops import tensor_parallel

    y = torch.matmul(hidden.float(), head[i].float())
    if tensor_parallel.shard_of(n_vocab) is None:
        return y
    return tensor_parallel.all_gather_last(y)


def quant_linear(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Linear over a quantized dict, dispatched on the code type as in JAX:
    signed int8 codes (W8A8, and W4A8 in int8 carriers) go through
    `w8a8_matvec` at every row count;
    unsigned (affine) codes through `affine_matvec` at <= 64 rows, else the
    weight dequantized to x.dtype and one matmul. The affine code width and
    group come from the stored arrays against x's width."""
    wq = params["weight_q"]
    lead = x.shape[:-1]
    in_dim = x.shape[-1]
    xf = x.reshape(-1, in_dim)
    if wq.dtype == torch.int8:
        y = w8a8_matvec(xf, wq, params["scales"], params["biases"])
    elif wq.dtype == torch.uint8:
        if xf.shape[0] <= AFFINE_MAX_ROWS:
            y = affine_matvec(xf, wq, params["scales"], params["biases"])
        else:
            w = dequantize_weight(params, code_bits(wq, in_dim), x.dtype)
            y = torch.matmul(xf, w.t())
    else:
        raise ValueError(f"quant_linear: codes of type {wq.dtype} are not "
                         f"ported (int8 W8A8 / W4A8 or uint8 affine)")
    y = y.reshape(*lead, -1)
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


# --- model quantization -----------------------------------------------------


def _quantize_tree(tree: Any, bits: int, group_size: int, min_size: int,
                   path: str = "", mode: str = "affine") -> Any:
    if isinstance(tree, dict):
        # "codebook" guards RVQ codebooks, not the codebook0_head Linear.
        blocked = any(t in path for t in _NO_QUANT) \
            and "codebook0_head" not in path
        if "dora_m" in tree:
            warnings.warn(
                f"quantize_model: skipping DoRA-adapted '{path}' — the "
                f"per-row renormalization needs the dense weight.")
            return tree
        w = tree.get("weight")
        if isinstance(w, torch.Tensor) and w.dim() == 2 and not blocked:
            # w8a8/w4a8 are per-channel: no input-group alignment needed.
            align = 1 if mode in _PER_CHANNEL else group_size
            large = w.numel() >= min_size
            if large and w.shape[-1] % align == 0:
                new = {k: v for k, v in tree.items() if k != "weight"}
                new.update(quantize_weight_w8(w, _PER_CHANNEL[mode])
                           if mode in _PER_CHANNEL
                           else quantize_weight(w, bits, group_size))
                return new
            if large:  # large enough but misaligned: say so
                warnings.warn(
                    f"quantize_model: skipping '{path}' — in_dim "
                    f"{w.shape[-1]} is not a multiple of group_size "
                    f"{align}; weight stays "
                    f"{str(w.dtype).replace('torch.', '')}.")
            return tree
        return {k: _quantize_tree(v, bits, group_size, min_size,
                                  f"{path}.{k}", mode)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_quantize_tree(v, bits, group_size, min_size, f"{path}.{i}",
                               mode)
                for i, v in enumerate(tree)]
    return tree


def quantize_model(model, bits: int = DEFAULT_BITS,
                   group_size: int = DEFAULT_GROUP_SIZE,
                   min_size: int = 1 << 16, mode: str = "affine",
                   targets=("backbone", "decoder", "projection"),
                   fuse: bool = True) -> None:
    """Quantize the large Linear weights of `model.params` in place, then
    (with `fuse`) fold q/k/v and gate/up into single wide linears. The
    signature and defaults are the JAX package's.

    mode="affine" (default): MLX-parity grouped affine codes, `bits` 4 or 8
    and `group_size` (4-bit, group 64 by default, as `nn.quantize`); a leaf
    whose IN is not a multiple of `group_size` stays as it is, with a
    warning. mode="w8a8": per-channel int8 weights with dynamic int8
    activations; mode="w4a8": the same with codes in [-7, 7] in int8
    carriers; in both `bits`/`group_size` are ignored.

    Embeddings and norms stay as they are, and DoRA leaves are skipped with
    a warning. An "audio_head" target becomes `quantize_audio_head`'s
    8-bit dict in W8A8 and W4A8 mode and is skipped in affine mode, as in
    JAX. On a CUDA model, W8A8 or W4A8 with `fuse` and the decoder among
    the targets also derives the whole-frame decoder's tables
    (`params["_resident"]`, `ops.resident_decoder`; not with the int8
    head); generation then runs each decoder frame as one kernel-3 launch
    per chunk of <= 64 rows. The affine path runs the dispatched
    decoder."""
    if mode not in ("affine",) + tuple(_PER_CHANNEL):
        raise ValueError(f"quantize_model: mode {mode!r} is not supported; "
                         f"'affine', 'w8a8' or 'w4a8'")
    p = model.params
    for key in targets:
        if key == "audio_head" and key in p and not isinstance(p[key], dict):
            if mode in _PER_CHANNEL:
                p[key] = quantize_audio_head(p[key])
            continue
        if key in p:
            p[key] = _quantize_tree(p[key], bits, group_size, min_size,
                                    path=key, mode=mode)
    if fuse:
        from csm_mlx_tpu_torch.models.llama import fuse_layer_weights

        for key in ("backbone", "decoder"):
            if key in p:
                fuse_layer_weights(p[key])
    if mode in _PER_CHANNEL and fuse and "decoder" in targets \
            and model.device.type == "cuda":
        from csm_mlx_tpu_torch.ops.resident_decoder import \
            prepare_resident_decoder

        prepare_resident_decoder(model)

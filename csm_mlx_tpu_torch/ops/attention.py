"""Grouped-query attention (port of `csm_mlx_tpu/ops/attention.py`).

Layouts as in the JAX package: q (B, H, S, D), k/v (B, n_kv, S_k, D).
Logits and softmax run in fp32 whatever the compute type; masks are
additive fp32 biases with the finite `NEG_INF` (a fully masked row then
averages V instead of turning into NaN).

`flash_prefill_sdpa` is kernel 2 of the port: on a CUDA tensor it launches
the hand-written kernel of `csrc/flash_prefill.cu`; on a CPU tensor it runs
its plain PyTorch version, `flash_prefill_plain`.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def causal_mask_bias(q_len: int, k_len: int, q_offset: int = 0,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """(q_len, k_len) additive fp32 bias; query i attends keys <= i+offset."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(k_len, device=device)[None, :]
    return torch.where(k_pos <= q_pos, 0.0, NEG_INF).float()


def key_validity_bias(valid: torch.Tensor) -> torch.Tensor:
    """(..., k_len) boolean key validity -> additive bias (..., 1, k_len)."""
    return torch.where(valid, 0.0, NEG_INF).float()[..., None, :]


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    mask_bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention with implicit GQA.

    mask_bias broadcasts to (B, 1|H, S_q, S_k) as in the JAX `sdpa`.
    Returns (B, H, S_q, D) in q.dtype.
    """
    b, n_heads, s_q, d = q.shape
    n_kv = k.shape[1]
    group = n_heads // n_kv
    qg = q.reshape(b, n_kv, group, s_q, d).float()
    logits = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2))
    logits = logits * scale  # (B, n_kv, g, S_q, S_k)
    if mask_bias is not None:
        if mask_bias.dim() == 2:
            bias = mask_bias[None, None, None]
        elif mask_bias.dim() == 3:
            bias = mask_bias[:, None, None]
        elif mask_bias.dim() == 4:
            if mask_bias.shape[1] == n_heads:
                bias = mask_bias.reshape(mask_bias.shape[0], n_kv, group,
                                         s_q, -1)
            else:
                bias = mask_bias[:, :, None]
        else:
            bias = mask_bias
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()[:, :, None])
    return out.reshape(b, n_heads, s_q, d).to(q.dtype)


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, pad_len: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 2: the masked `sdpa` with the causal
    and left-pad masks over the S prompt keys."""
    s = q.shape[2]
    causal = causal_mask_bias(s, s, device=q.device)
    key_valid = (torch.arange(s, device=q.device)[None, :]
                 >= pad_len.reshape(-1, 1).to(q.device))
    bias = torch.clamp(causal[None, None] + key_validity_bias(key_valid)[:, None],
                       min=NEG_INF)
    return sdpa(q, k, v, scale, bias)


def flash_prefill_sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    pad_len: torch.Tensor,
) -> torch.Tensor:
    """Prefill attention, causal + left-pad masks computed in the kernel.

    q: (B, H, S, D); k, v: (B, n_kv, S, D) — may be `cache[:, :, :S]`
    views: the kernel reads them through their strides (no copy).
    pad_len: (B,) left pads; query i attends key j iff pad_len[b] <= j <= i.
    On CUDA: D == 64, S % 64 == 0, fp32 or bf16. Returns (B, H, S, D) in
    q.dtype, contiguous.
    """
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, scale, pad_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_sdpa: unsupported device {q.device}")
    from csm_mlx_tpu_torch.ops import _build

    b, n_heads, s, d = q.shape
    n_kv = k.shape[1]
    if d != 64 or s % 64 or n_heads % n_kv:
        raise ValueError(
            f"flash_prefill_sdpa kernel takes D=64, S%64==0 and H%n_kv==0; "
            f"got D={d}, S={s}, H={n_heads}, n_kv={n_kv}")
    if k.shape != (b, n_kv, s, d) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_prefill_sdpa: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes fp32 or bf16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.device != q.device:
            raise ValueError(f"flash_prefill_sdpa: {name} must lie on "
                             f"{q.device} with a contiguous last dim")
    pad = pad_len.reshape(b).to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, n_heads, s, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    code = lib.csm_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
        out.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        b, n_heads, n_kv, s, d, float(scale), _build.DTYPE_CODES[q.dtype],
        _build.stream_ptr(q.device))
    _build.check(code, "csm_flash_prefill")
    flash_prefill_sdpa.launches += 1
    return out


flash_prefill_sdpa.launches = 0

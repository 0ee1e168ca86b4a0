"""Differentiable causal flash attention for training (port of
`csm_mlx_tpu/ops/flash_train.py`).

`flash_attention(q, k, v, scale)` is causal grouped-query attention whose
forward and backward are kernels 6 and 7 of the port
(`csrc/flash_train.cu`), joined by a `torch.autograd.Function`: no
(B, H, S, S) logits in device memory in either pass. The forward saves O
and the fp32 logsumexp (B, H, S); the backward recomputes the
probabilities from them (FlashAttention-2; the JAX kernel saves no
logsumexp and recomputes it, with the same result).

The wrappers `flash_train_fwd` and `flash_train_bwd` launch the kernels on
CUDA tensors and run the plain versions, `flash_train_fwd_plain` and
`flash_train_bwd_plain`, on CPU tensors. Any S is accepted: the kernels
mask the tail tile where JAX pads to 128 and slices back.

Types: the softmax and every sum are fp32; O and dq come back in q's type,
dk and dv are summed in fp32 and cast to k's type. On the card, bf16 runs
on the tensor cores, which round P and dS to bf16 where they are the
operand of their second product (P V, dS K, P^T dO, dS^T Q), as
FlashAttention-2 does; fp32 runs on the CUDA cores in fp32 throughout.
q/k/v/dO are read through their strides (they arrive as transposed views
of the projections); a tensor whose last dim is not contiguous, or, in
bf16, whose rows are not 16-byte aligned, is copied first.
"""

from __future__ import annotations

import torch

from csm_mlx_tpu_torch.ops import launches
from csm_mlx_tpu_torch.ops.attention import NEG_INF


def _logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Masked fp32 logits (B, n_kv, group, S, S) of causal GQA attention."""
    b, n_heads, s, d = q.shape
    n_kv = k.shape[1]
    qg = q.reshape(b, n_kv, n_heads // n_kv, s, d).float()
    logits = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * scale
    pos = torch.arange(s, device=q.device)
    return logits.masked_fill(pos[None, :] > pos[:, None], NEG_INF)


def flash_train_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 6: (O in q's type, fp32 logsumexp (B, H, S))
    from the masked fp32 logits."""
    b, n_heads, s, d = q.shape
    logits = _logits(q, k, scale)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = torch.matmul(p, v.float()[:, :, None])
    return (out.reshape(b, n_heads, s, d).to(q.dtype),
            lse.reshape(b, n_heads, s))


def flash_train_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, scale: float
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel 7: fp32 (dq, dk, dv) from the recomputed
    probabilities, the formula of the JAX backward kernel —
    delta = rowsum(dO * O), dS = P * (dO V^T - delta) * scale, dq = dS K,
    dk = dS^T q and dv = P^T dO, both summed over the query group."""
    b, n_heads, s, d = q.shape
    n_kv = k.shape[1]
    group = n_heads // n_kv
    p = torch.softmax(_logits(q, k, scale), dim=-1)  # (B, n_kv, g, S, S)
    qg = q.reshape(b, n_kv, group, s, d).float()
    dog = do.reshape(b, n_kv, group, s, d).float()
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    o = torch.matmul(p, vf)
    delta = (dog * o).sum(dim=-1, keepdim=True)
    dp = torch.matmul(dog, vf.transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf).reshape(b, n_heads, s, d)
    dk = torch.matmul(ds.transpose(-1, -2), qg).sum(dim=2)
    dv = torch.matmul(p.transpose(-1, -2), dog).sum(dim=2)
    return dq, dk, dv


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str):
    b, n_heads, s, d = q.shape
    n_kv = k.shape[1]
    if d != 64:
        raise ValueError(f"{name}: the kernel takes head_dim 64, got {d}")
    if n_heads % n_kv or k.shape != (b, n_kv, s, d) or v.shape != k.shape:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)}/"
                         f"{tuple(v.shape)} does not match q {tuple(q.shape)}")
    from csm_mlx_tpu_torch.ops import _build

    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         f"the kernel takes fp32 or bf16")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: q/k/v lie on different devices")


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides of dims 0-2; 0 for a dim of size 1, which the kernel
    never steps over (its stride is arbitrary)."""
    return tuple(t.stride(i) if t.shape[i] > 1 else 0 for i in range(3))


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """`t` itself where the kernel can read it through its strides: the
    last dim contiguous and, for the bf16 route's 16-byte copies, rows
    16-byte aligned; else a fresh contiguous copy (`contiguous()` would
    return a misaligned contiguous view unchanged)."""
    ok = t.stride(-1) == 1
    if ok and t.dtype == torch.bfloat16:
        ok = t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in _strides(t))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def flash_train_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 6 on CUDA tensors (plain version on CPU tensors): (O (B, H,
    S, D) in q's type, logsumexp (B, H, S) fp32)."""
    if q.device.type == "cpu":
        return flash_train_fwd_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_train_fwd: unsupported device {q.device}")
    from csm_mlx_tpu_torch.ops import _build

    _check(q, k, v, "flash_train_fwd")
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    b, n_heads, s, d = q.shape
    out = torch.empty((b, n_heads, s, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n_heads, s), dtype=torch.float32, device=q.device)
    code = _build.library().csm_flash_train_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_strides(q), *_strides(k), *_strides(v),
        b, n_heads, k.shape[1], s, d, float(scale),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    _build.check(code, "csm_flash_train_fwd")
    flash_train_fwd.launches += 1
    return out, lse


def flash_train_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    scale: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 7 on CUDA tensors (plain version on CPU tensors, which
    recomputes O and the softmax from q, k, v): (dq in q's type, dk and dv
    in k's type)."""
    if q.device.type == "cpu":
        dq, dk, dv = flash_train_bwd_plain(q, k, v, do, scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_train_bwd: unsupported device {q.device}")
    from csm_mlx_tpu_torch.ops import _build

    _check(q, k, v, "flash_train_bwd")
    b, n_heads, s, d = q.shape
    if do.shape != q.shape or o.shape != q.shape \
            or lse.shape != (b, n_heads, s):
        raise ValueError("flash_train_bwd: o/dO/lse do not match q")
    q, k, v, do = (_kernel_layout(t.to(q.dtype)) for t in (q, k, v, do))
    o = _kernel_layout(o.to(q.dtype).contiguous())
    lse = lse.float().contiguous()
    n_kv = k.shape[1]
    delta = torch.empty((b, n_heads, s), dtype=torch.float32, device=q.device)
    # fp32 dk/dv of each query head, summed over the group by the kernel's
    # last pass (the bf16 route only)
    partial = torch.empty((2, b, n_heads, s, d), dtype=torch.float32,
                          device=q.device) \
        if q.dtype == torch.bfloat16 else None
    dq = torch.empty_like(o)
    dk = torch.empty((b, n_kv, s, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    code = _build.library().csm_flash_train_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
        None if partial is None else partial.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *_strides(q), *_strides(k),
        *_strides(v), *_strides(do), b, n_heads, n_kv, s, d, float(scale),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    _build.check(code, "csm_flash_train_bwd")
    flash_train_bwd.launches += 1
    return dq, dk, dv


launches.register(flash_train_fwd)
launches.register(flash_train_bwd)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_train_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_train_bwd(q, k, v, out, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Causal GQA attention, differentiable, with no (S, S) tensor in device
    memory on the card.

    q: (B, H, S, D); k, v: (B, n_kv, S, D), H % n_kv == 0; query i attends
    keys j <= i (exactly `sdpa(..., causal_mask_bias(S, S))`). Returns
    (B, H, S, D) in q's type. On the card D must be 64 and the type fp32
    or bf16.
    """
    return _FlashAttention.apply(q, k, v, scale)

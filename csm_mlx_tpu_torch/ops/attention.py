"""Grouped-query attention (port of `csm_mlx_tpu/ops/attention.py`).

Layouts as in the JAX package: q (B, H, S, D), k/v (B, n_kv, S_k, D).
Logits and softmax run in fp32 whatever the compute type; masks are
additive fp32 biases with the finite `NEG_INF` (a fully masked row then
averages V instead of turning into NaN).

`flash_prefill_sdpa` is kernel 2 of the port: on a CUDA tensor it launches
the hand-written kernel of `csrc/flash_prefill.cu`; on a CPU tensor it runs
its plain PyTorch version, `flash_prefill_plain`. `flash_decode_sdpa` is
kernel 4 (`csrc/flash_decode.cu`), with `flash_decode_plain` beside it; it
splits the cache over `decode_splits(B, n_kv, cap)` blocks a (row, kv head):
a K pass, a V pass and a merge of the splits in split order.
"""

from __future__ import annotations

import torch

from csm_mlx_tpu_torch.ops import launches

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# Kernel 4's split of the cache (flash-decoding), for the H100's 132 SMs:
# from DECODE_ONE_SPLIT_BLOCKS (row, kv head) blocks up (2 an SM; B >= 33
# at 8 kv heads) one split fills the card and there is no merge launch;
# below, the cache is cut into chunks of a multiple of 64 keys, aiming at
# DECODE_TARGET_BLOCKS blocks (4 an SM), one tile of 64 keys at least each.
DECODE_ONE_SPLIT_BLOCKS = 264
DECODE_TARGET_BLOCKS = 528
DECODE_CHUNK_ALIGN = 64


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


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides of dims 0-2 as the kernels take them: 0 for a dim of
    size 1, which they never step over (its stride is arbitrary)."""
    return tuple(t.stride(i) if t.shape[i] > 1 else 0 for i in range(3))


def _check_rows(name: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> None:
    """Raise unless q, k and v lie on q's device with contiguous, 16-byte
    aligned rows, as the kernels read them in place through their strides:
    they never copy."""
    vec = 16 // q.element_size()  # elements of one 16-byte load
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.device != q.device:
            raise ValueError(f"{name}: {label} must lie on {q.device} with a "
                             f"contiguous last dim")
        if t.data_ptr() % 16 or any(st % vec for st in _strides(t)):
            raise ValueError(f"{name}: {label}'s rows must be 16-byte "
                             f"aligned")


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
    On CUDA: D == 64, S % 64 == 0, fp32 or bf16, rows 16-byte aligned.
    Returns (B, H, S, D) in q.dtype, contiguous; on CUDA in bf16 the rows
    i < pad_len[b], which no valid row attends to, are zeros.
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
    _check_rows("flash_prefill_sdpa", q, k, v)
    pad = pad_len.reshape(b).to(device=q.device, dtype=torch.int64).contiguous()
    out = torch.empty((b, n_heads, s, d), dtype=q.dtype, device=q.device)
    code = _build.library().csm_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
        out.data_ptr(),
        *_strides(q), *_strides(k), *_strides(v), b, n_heads, n_kv, s, d,
        float(scale), _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    _build.check(code, "csm_flash_prefill")
    flash_prefill_sdpa.launches += 1
    return out


launches.register(flash_prefill_sdpa)


def kv_prefix_buckets(capacity: int, min_capacity: int = 1024,
                      start: int = 512, step: int = 256) -> tuple:
    """Host-side table of KV prefix lengths for bucketed decode attention
    (a copy of the JAX package's): ascending lengths from `start` by
    `step`, ending at `capacity`; () when the buffer is small enough that
    reading it whole is cheap, or with `CSM_TPU_KV_BUCKETS=0`.

    A decode step's attention reads every slot of the cache it is given,
    so the continuous engine gives each step block a prefix view of its
    cache, `kv_bucket_for` the live end of it: the dead tail is never
    read. Masked slots add exactly 0 to the softmax, so a prefix changes
    no result beyond the order of the sums."""
    import os

    if capacity < min_capacity or \
            os.environ.get("CSM_TPU_KV_BUCKETS", "1") == "0":
        return ()
    buckets = list(range(start, capacity, step))
    buckets.append(capacity)
    return tuple(buckets)


def kv_bucket_for(live_end: int, buckets: tuple) -> int | None:
    """The smallest bucket covering `live_end` leading KV slots (the last
    one past it); None when buckets are off."""
    if not buckets:
        return None
    for b in buckets:
        if b >= live_end:
            return b
    return buckets[-1]


def decode_splits(batch: int, n_kv: int, cap: int) -> tuple[int, int]:
    """(splits, chunk) of kernel 4 for a cache of `cap` slots: `splits`
    blocks a (row, kv head), each over `chunk` keys (a multiple of 64; the
    last chunk may be shorter). A function of the cache's shape only, never
    of the decode index, so a cache keeps one grid for all its steps."""
    blocks = batch * n_kv
    want = 1 if blocks >= DECODE_ONE_SPLIT_BLOCKS else min(
        -(-DECODE_TARGET_BLOCKS // blocks), -(-cap // DECODE_CHUNK_ALIGN))
    chunk = DECODE_CHUNK_ALIGN * -(-cap // (DECODE_CHUNK_ALIGN * want))
    return -(-cap // chunk), chunk


def _check_index(index, device) -> None:
    if not isinstance(index, torch.Tensor) or index.dim() > 1 \
            or index.numel() != 1 or index.dtype != torch.int32 \
            or index.device != device:
        raise ValueError(f"flash_decode_sdpa: index must be a () or (1,) "
                         f"int32 tensor on {device}")


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, pad_len: torch.Tensor,
                       index: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 4: the masked `sdpa` with the decode
    step's key mask pad_len[b] <= pos <= index (a () or (1,) int32 tensor
    on q's device, as the kernel takes)."""
    _check_index(index, q.device)
    pos = torch.arange(k.shape[2], device=q.device)[None, :]
    pad = pad_len.reshape(-1, 1).to(q.device)
    valid = (pos >= pad) & (pos <= index.reshape(()))
    return sdpa(q, k, v, scale, key_validity_bias(valid)[:, None])


def flash_decode_sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    pad_len: torch.Tensor,
    index: torch.Tensor,
) -> torch.Tensor:
    """Decode-step attention of one query position over the whole cache.

    q: (B, H, 1, D); k, v: (B, n_kv, cap, D), the cache's layer buffers
    after this step's write — read through their strides (no copy);
    pad_len: (B,) left pads; index: the cache's pre-advance write slot,
    its () int32 index tensor (`KVCache.index`, or a (1,) one) on q's
    device, which the kernel reads from device memory, so that a launch
    captured in a CUDA graph follows the cache at every replay. Key j is valid iff pad_len[b] <= j <= index. On CUDA: D == 64,
    H / n_kv in {1, 2, 4, 8}, fp32 or bf16, rows 16-byte aligned. Returns
    (B, H, 1, D) in q.dtype, contiguous.
    """
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, scale, pad_len, index)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_sdpa: unsupported device {q.device}")
    from csm_mlx_tpu_torch.ops import _build

    b, n_heads, s, d = q.shape
    n_kv, cap = k.shape[1], k.shape[2]
    if s != 1 or d != 64 or n_heads % n_kv \
            or n_heads // n_kv not in (1, 2, 4, 8):
        raise ValueError(
            f"flash_decode_sdpa kernel takes one query position, D=64 and "
            f"H/n_kv in (1, 2, 4, 8); got S={s}, D={d}, H={n_heads}, "
            f"n_kv={n_kv}")
    if k.shape != (b, n_kv, cap, d) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    _check_index(index, q.device)
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_decode_sdpa: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes fp32 or bf16")
    _check_rows("flash_decode_sdpa", q, k, v)
    pad = pad_len.reshape(b).to(device=q.device, dtype=torch.int64).contiguous()
    out = torch.empty((b, n_heads, 1, d), dtype=q.dtype, device=q.device)
    splits, chunk = decode_splits(b, n_kv, cap)
    # fp32 scratch: the scores (B, H, cap), and with splits their partials,
    # (max, sum, P.V[64]) a (row, head, split)
    n_scores = -(-b * n_heads * cap // 4) * 4
    scratch = torch.empty(n_scores + (b * n_heads * splits * (d + 2)
                                      if splits > 1 else 0),
                          dtype=torch.float32, device=q.device)
    code = _build.library().csm_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
        out.data_ptr(), scratch.data_ptr(),
        *_strides(q)[:2], *_strides(k), *_strides(v), b, n_heads, n_kv, cap,
        index.data_ptr(), splits, chunk, d, float(scale),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    _build.check(code, "csm_flash_decode")
    flash_decode_sdpa.launches += 1
    return out


launches.register(flash_decode_sdpa)

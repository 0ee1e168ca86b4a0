"""The whole-frame decoder (kernel 3 of the port; port of
`csm_mlx_tpu/ops/resident_decoder.py`).

One call runs a whole CSM decoder frame for a batch of <= 64 rows: the
2-token prime ([backbone hidden, c0 embedding], already projected: `proj01`)
and 30 single-token steps of the 4-layer W8A8 decoder over a 32-slot KV
cache, each step scored against its int8 audio head and sampled (greedy
argmax, or Gumbel-max at a temperature), the sampled token's projected
embedding gathered from `embed_tab` as the next step's input. It returns
the tokens (n_cb, B) int32: row 0 zeros (c0 is sampled by the caller),
rows 1..31 codebooks 1..31.

On CUDA tensors `resident_decode_frame` launches the hand-written kernel of
`csrc/resident_frame.cu`: ONE cooperative launch per call, one block per
SM, whose phases (the W8A8 matvecs on the int8 tensor cores, each with its
per-row preparation, attention, the head and the pick) are separated by
grid-wide barriers; every step streams the codes. On CPU tensors it runs
`resident_decode_frame_plain`, the same arithmetic step by step in torch.

The arithmetic is the JAX kernel's default variant set at B <= 8, for every
B: RoPE as elementwise products on interleaved pairs (`vpu_rope`), attention
over each row's own KV (`merged_attn`), the symmetric per-column int8 audio
head (`int8_head`), and f32 KV (the JAX kernel keeps its KV in bf16 past
B = 8 to fit VMEM; the port does not). Not ported: the variant switches
(`CSM_TPU_RESIDENT_OPTS`, `classic`, the `probe_*` arms), the rotation-
matrix RoPE and `effective_max_batch` — TPU memory plans and bench arms.

Tables (`prepare_resident_decoder`, or carried from the JAX package by
`bridge.resident_to_torch`, in the same layout):
- "layers": per layer [ln1 (1, d) f32, qkv codes (3*.., d) int8, qkv
  scale/bias rows (2, OUT) f32, o codes, o rows, ln2, gate-up codes,
  gate-up rows, down codes, down rows] — the JAX order;
- "norm" (1, d) f32; "rope_cs" (n_cb, 3, hd) f32, the JAX `_rope_cs` rows;
- "embed_tab" ((n_cb-2) * v, d) f32: projected audio embeddings of
  codebooks 1..n_cb-2;
- "audio_head_q" (n_cb-1, v_pad, d) int8 — the JAX (n_cb-1, d, v_pad) codes
  transposed, so that one head column's codes are contiguous — and
  "audio_head_s" (n_cb-1, v_pad) f32. JAX's bf16 padded head is not kept:
  only its int8 form is read.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from csm_mlx_tpu_torch.ops import launches
from csm_mlx_tpu_torch.ops.quant import _int_dot
from csm_mlx_tpu_torch.ops.rope import rope_cache
from csm_mlx_tpu_torch.ops.sampling import SamplerConfig

NEG = -1e30
RESIDENT_MAX_BATCH = 64  # rows per kernel call; larger batches are chunked
MAX_LAYERS = 8  # kMaxLayers of csrc/resident_frame.cu
_BLOCKS_PER_SM = 1  # the kernel's grid: one block per SM
# The JAX kernel's `absmax * (1.0 / 127.0)`: a product with the fp32 constant.
_INV_127 = float(np.float32(1.0 / 127.0))
_EMBED_CHUNK = 8192  # embed_tab rows projected per kernel-1 call, as in JAX
# The kinds of the kernel's phase records (enum Phase of
# csrc/resident_frame.cu), by code.
PHASE_KINDS = ("pick", "prep", "qkv", "attention", "o", "gate-up", "down",
               "head", "end")


def rope_cs(head_dim: int, rope_theta: float, rope_scaling, cap: int
            ) -> np.ndarray:
    """(cap, 3, hd) f32 rows of interleaved-pair RoPE, the JAX `_rope_cs`:
    out = x * row[0] + roll(x, -1) * row[1] + roll(x, +1) * row[2], i.e.
    out[2i] = x[2i] cos_i - x[2i+1] sin_i, out[2i+1] = x[2i+1] cos_i +
    x[2i] sin_i."""
    cos, sin = rope_cache(head_dim, rope_theta, rope_scaling, cap)
    t = np.zeros((cap, 3, head_dim), np.float32)
    idx = np.arange(head_dim // 2)
    t[:, 0, 2 * idx] = cos
    t[:, 0, 2 * idx + 1] = cos
    t[:, 1, 2 * idx] = -sin
    t[:, 2, 2 * idx + 1] = sin
    return t


def _as_sz(qp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(OUT, 1) scales and biases -> the (2, OUT) f32 row pair."""
    return torch.cat([qp["scales"].reshape(1, -1),
                      qp["biases"].reshape(1, -1)]).float().contiguous()


def _row(t: torch.Tensor) -> torch.Tensor:
    return t.float().reshape(1, -1).contiguous()


def prepare_resident_decoder(model) -> bool:
    """Derive the kernel's tables into `model.params["_resident"]`.

    Needs the decoder's codes in int8 with fused qkv / gate-up
    (`quantize_model(mode="w8a8" or "w4a8", fuse=True)`), a raw audio_head
    (the int8 head of `quantize_audio_head` is not the kernel's) and no
    LoRA adapters on what the tables bake in. Returns False and leaves the
    params as they were otherwise: generation then keeps the dispatched
    decoder."""
    from csm_mlx_tpu_torch.ops.layers import linear

    p = model.params
    args = model.args
    dcfg = args.decoder_config
    dec = p.get("decoder")
    head = p.get("audio_head")
    if not dec or head is None or isinstance(head, dict):
        return False
    if dcfg.num_attention_heads * dcfg.head_dim != dcfg.hidden_size:
        return False
    if any(isinstance(p.get(k), dict) and "lora_a" in p[k]
           for k in ("projection", "audio_embeddings")):
        return False

    layers = []
    for lp in dec["layers"]:
        at, mlp = lp["self_attn"], lp["mlp"]
        if "qkv_proj" not in at or "gateup_proj" not in mlp:
            return False
        parts = (at["qkv_proj"], at["o_proj"], mlp["gateup_proj"],
                 mlp["down_proj"])
        if any("weight_q" not in q or q["weight_q"].dtype != torch.int8
               or "lora_a" in q for q in parts):
            return False
        qkv, o, gu, dn = parts
        layers.append([
            _row(lp["input_layernorm"]["weight"]),
            qkv["weight_q"].contiguous(), _as_sz(qkv),
            o["weight_q"].contiguous(), _as_sz(o),
            _row(lp["post_attention_layernorm"]["weight"]),
            gu["weight_q"].contiguous(), _as_sz(gu),
            dn["weight_q"].contiguous(), _as_sz(dn),
        ])

    n_cb, v = args.n_audio_codebooks, args.n_audio_vocab
    v_pad = -(-v // 128) * 128
    # Projected embeddings of codebooks 1..n_cb-2 in f32, through the
    # projection's own linear (kernel 1 on CUDA when it is W8A8): a step's
    # projection matvec becomes a row gather.
    rows = p["audio_embeddings"]["weight"][v:(n_cb - 1) * v]
    with torch.no_grad():
        tab = torch.cat([linear(p["projection"],
                                rows[i:i + _EMBED_CHUNK].float()).float()
                         for i in range(0, rows.shape[0], _EMBED_CHUNK)])
    device = rows.device
    res = {
        "layers": layers,
        "norm": _row(dec["norm"]["weight"]),
        "rope_cs": torch.from_numpy(rope_cs(
            dcfg.head_dim, dcfg.rope_theta, dcfg.rope_scaling,
            n_cb)).to(device),
        "embed_tab": tab.contiguous(),
    }
    set_resident_audio_head(res, head, v_pad)
    p["_resident"] = res
    return True


def set_resident_audio_head(res: Dict[str, Any], head: torch.Tensor,
                            v_pad: int) -> None:
    """(Re)derive the int8 head tables from a raw (n_cb-1, d, v) head, as
    the JAX function does: the head rounded to bf16 and zero-padded to
    v_pad columns, then symmetric per-column codes q = round(h / s) with
    s = max(max_d |h| / 127, 1e-12). Stores "audio_head_q" (n_cb-1, v_pad,
    d) int8 and "audio_head_s" (n_cb-1, v_pad) f32."""
    v = head.shape[-1]
    with torch.no_grad():
        hf = F.pad(head.to(torch.bfloat16), (0, v_pad - v)).float()
        amax = hf.abs().amax(dim=1, keepdim=True)       # (n_cb-1, 1, v_pad)
        # true divisions, as the eager JAX call runs them
        s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
        q = torch.clamp(torch.round(hf / s), -127, 127).to(torch.int8)
    res["audio_head_q"] = q.transpose(1, 2).contiguous()
    res["audio_head_s"] = s.reshape(s.shape[0], v_pad).contiguous()


def sampler_supported(sampler) -> bool:
    """The kernel samples greedy and plain temperature-categorical, which is
    what the decoder codebooks use for any plain `SamplerConfig` (its other
    settings act on c0, sampled outside). A custom sampler, subclasses
    included, keeps the dispatched decoder."""
    return type(sampler) is SamplerConfig


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


# The plain version sums in the kernel's order, so that on the card the two
# agree to the bit: int8 requantization would otherwise turn a last-bit
# difference into a whole code step now and then, and through 4 layers and
# the 32-slot KV cache of random weights that grows to ~0.1 of the logits'
# std, as much as the plain version moves when its input moves by 1e-6.
_THREADS = 256  # kThreads of csrc/resident_frame.cu: one block per row


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """The kernel's butterfly sum over the last axis of 32 lanes."""
    lane = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ off]
    return v[..., 0]


def _thread_sums(v: torch.Tensor, threads: int) -> torch.Tensor:
    """(..., threads) partial sums of the last axis: thread t adds elements
    t, t + threads, ... in turn."""
    n = v.shape[-1]
    v = F.pad(v, (0, -n % threads)).reshape(*v.shape[:-1], -1, threads)
    acc = v[..., 0, :]
    for i in range(1, v.shape[-2]):
        acc = acc + v[..., i, :]
    return acc


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as one warp of the kernel takes it."""
    return _warp_sum(_thread_sums(v, 32))


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as the kernel's block_sum takes it: per-thread
    sums, each warp's butterfly, then warps 0..7 added in order."""
    acc = _thread_sums(v, _THREADS)
    warps = _warp_sum(acc.reshape(*acc.shape[:-1], -1, 32))
    total = warps[..., 0]
    for w in range(1, warps.shape[-1]):
        total = total + warps[..., w]
    return total[..., None]


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes clip(rint(x * (127 / absmax))) with a true
    division, and absmax * f32(1/127)."""
    absmax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-6)
    xq = torch.clamp(torch.round(x * (torch.full_like(absmax, 127.0)
                                      / absmax)), -127, 127).to(torch.int8)
    return xq, absmax * _INV_127


def _mv(x: torch.Tensor, wq: torch.Tensor, sz: torch.Tensor) -> torch.Tensor:
    """The frame kernel's W8A8 matvec (JAX `_frame_kernel.mv`): per-row int8
    activation quant, exact int dot, P * s * (absmax * f32(1/127)) +
    z * sum(x)."""
    xq, inv = _quant(x)
    p = _int_dot(xq, wq).float()
    return p * sz[0:1] * inv + sz[1:2] * _block_sum(x)


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    ss = _block_sum(x * x)
    rr = 1 / torch.sqrt(ss / torch.full_like(ss, x.shape[-1]) + eps)
    return x * rr * g


def _rope(x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """x (..., hd) at one position; cs the (3, hd) row of `rope_cs`."""
    return (x * cs[0] + torch.roll(x, -1, dims=-1) * cs[1]
            + torch.roll(x, 1, dims=-1) * cs[2])


def _attend(q: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
            scale: float) -> torch.Tensor:
    """softmax(q.k * scale) . v over slots 0..s, as a warp of the kernel
    runs it: q (B, kv, group, hd); ks, vs (s+1, B, kv, 1, hd)."""
    sc = _lane_sum(q[None] * ks) * scale                # (s+1, B, kv, g)
    e = torch.exp(sc - sc.amax(dim=0, keepdim=True))
    total = _warp_sum(F.pad(e.movedim(0, -1), (0, 32 - e.shape[0])))
    pr = e / total
    out = pr[0, ..., None] * vs[0]
    for j in range(1, vs.shape[0]):
        out = out + pr[j, ..., None] * vs[j]
    return out


@torch.no_grad()
def resident_decode_frame_plain(res: Dict[str, Any], args,
                                proj01: torch.Tensor, temperature: float,
                                generator: Optional[torch.Generator] = None,
                                forced: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 3, step by step, in the kernel's
    order of operations.

    proj01: (2, B, d). Returns (tokens (n_cb, B) int32 — row 0 zeros —,
    logits (n_cb-1, B, v) f32 of codebooks 1..n_cb-1 before any Gumbel
    noise). With `forced` (n_cb, B), step s+1 reads the embedding of
    forced[s] instead of this run's own pick (teacher forcing); the
    returned tokens stay this run's picks. At T > 0 the uniform bits come
    from `generator`."""
    dcfg = args.decoder_config
    n_cb, v = args.n_audio_codebooks, args.n_audio_vocab
    heads, n_kv, hd = (dcfg.num_attention_heads, dcfg.num_key_value_heads,
                       dcfg.head_dim)
    attn, kvd, group = heads * hd, n_kv * hd, heads // n_kv
    f, eps, scale = dcfg.intermediate_size, dcfg.rms_norm_eps, hd ** -0.5
    layers = res["layers"]
    head_q, head_s = res["audio_head_q"], res["audio_head_s"]
    v_pad = head_q.shape[1]
    cs_tab = res["rope_cs"]
    b = proj01.shape[1]
    device = proj01.device

    kc = torch.zeros((len(layers), n_cb, b, kvd), device=device)
    vc = torch.zeros_like(kc)
    toks = torch.zeros((n_cb, b), dtype=torch.int32, device=device)
    all_logits = []
    cols = torch.arange(v_pad, device=device)[None]
    prev = None
    for s in range(n_cb):
        if s < 2:
            x = proj01[s].float()
        else:
            x = res["embed_tab"][(s - 2) * v + prev.long()]
        cs = cs_tab[s]
        for li, lw in enumerate(layers):
            ln1, qkv_q, qkv_sz, o_q, o_sz, ln2, gu_q, gu_sz, dn_q, dn_sz = lw
            qkv = _mv(_rms(x, ln1, eps), qkv_q, qkv_sz)
            q = _rope(qkv[:, :attn].reshape(b, heads, hd), cs)
            k = _rope(qkv[:, attn:attn + kvd].reshape(b, n_kv, hd), cs)
            kc[li, s] = k.reshape(b, kvd)
            vc[li, s] = qkv[:, attn + kvd:]
            # each head attends to its own kv group over slots 0..s
            a = _attend(q.reshape(b, n_kv, group, hd),
                        kc[li, :s + 1].reshape(s + 1, b, n_kv, 1, hd),
                        vc[li, :s + 1].reshape(s + 1, b, n_kv, 1, hd), scale)
            x = x + _mv(a.reshape(b, attn), o_q, o_sz)
            gu = _mv(_rms(x, ln2, eps), gu_q, gu_sz)
            act = gu[:, :f] * torch.sigmoid(gu[:, :f]) * gu[:, f:]
            x = x + _mv(act, dn_q, dn_sz)
        if s == 0:
            continue
        hq, inv = _quant(_rms(x, res["norm"], eps))
        logits = (_int_dot(hq, head_q[s - 1]).float() * head_s[s - 1][None]
                  * inv)
        logits = torch.where(cols < v, logits, NEG)
        pick = logits
        if temperature > 0.0:
            bits = torch.randint(0, 1 << 23, (b, v_pad), generator=generator,
                                 device=device)
            u = bits.float() * (1.0 / (1 << 23))
            g = -torch.log(-torch.log(u + 1e-10) + 1e-10)
            pick = torch.where(cols < v, logits * (1.0 / temperature) + g,
                               NEG)
        tok = torch.argmax(pick, dim=-1)  # the first index among equal maxima
        toks[s] = tok.to(torch.int32)
        all_logits.append(logits[:, :v])
        prev = forced[s] if forced is not None else tok
    return toks, torch.stack(all_logits)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------


def _check_tables(res: Dict[str, Any], args, device: torch.device) -> None:
    dcfg = args.decoder_config
    d, f = dcfg.hidden_size, dcfg.intermediate_size
    heads, n_kv, hd = (dcfg.num_attention_heads, dcfg.num_key_value_heads,
                       dcfg.head_dim)
    attn, kvd = heads * hd, n_kv * hd
    n_cb, v = args.n_audio_codebooks, args.n_audio_vocab
    n_layers = len(res["layers"])
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"resident_decode_frame: {n_layers} layers; the "
                         f"kernel takes 1..{MAX_LAYERS}")
    if n_cb > 32 or n_cb < 3:
        raise ValueError(f"resident_decode_frame: {n_cb} codebooks; the "
                         f"kernel takes 3..32 (one KV slot per lane)")
    if attn != d or heads % n_kv or hd % 4 or any(
            n % 32 for n in (d, f, attn)) or (attn + 2 * kvd) % 16:
        raise ValueError("resident_decode_frame: the kernel needs heads*hd "
                         "== d, whole kv groups, a head_dim multiple of 4, d "
                         "and f multiples of 32 and qkv rows a multiple of "
                         "16")
    v_pad = res["audio_head_q"].shape[1]
    want = [
        ("norm", res["norm"], (1, d), torch.float32),
        ("rope_cs", res["rope_cs"], (n_cb, 3, hd), torch.float32),
        ("embed_tab", res["embed_tab"], ((n_cb - 2) * v, d), torch.float32),
        ("audio_head_q", res["audio_head_q"], (n_cb - 1, v_pad, d),
         torch.int8),
        ("audio_head_s", res["audio_head_s"], (n_cb - 1, v_pad),
         torch.float32),
    ]
    lshapes = [((1, d), torch.float32), ((attn + 2 * kvd, d), torch.int8),
               ((2, attn + 2 * kvd), torch.float32), ((d, attn), torch.int8),
               ((2, d), torch.float32), ((1, d), torch.float32),
               ((2 * f, d), torch.int8), ((2, 2 * f), torch.float32),
               ((d, f), torch.int8), ((2, d), torch.float32)]
    for li, lw in enumerate(res["layers"]):
        if len(lw) != 10:
            raise ValueError(f"resident_decode_frame: layer {li} has "
                             f"{len(lw)} tables, not 10")
        for j, (t, (shape, dtype)) in enumerate(zip(lw, lshapes)):
            want.append((f"layers[{li}][{j}]", t, shape, dtype))
    for name, t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"resident_decode_frame: {name} is "
                             f"{tuple(t.shape)} {t.dtype}, want {shape} "
                             f"{dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"resident_decode_frame: {name} must be "
                             f"contiguous on {device}")
        if t.dtype == torch.int8 and t.data_ptr() % 16:
            raise ValueError(f"resident_decode_frame: {name} must be "
                             f"16-byte aligned")
    if v_pad < v or v_pad % 16:
        raise ValueError(f"resident_decode_frame: v_pad {v_pad} must be a "
                         f"multiple of 16 >= {v}")


def resident_decode_frame(res: Dict[str, Any], args, proj01: torch.Tensor,
                          seed: torch.Tensor, temperature: float,
                          return_logits: bool = False):
    """Kernel 3: one decoder frame for B <= 64 rows. proj01 (2, B, d);
    `seed` feeds the kernel's counter-based generator at T > 0: a () or
    (1,) int32 tensor on proj01's device, which the kernel reads from
    device memory (so a launch captured in a CUDA graph takes the seed its
    step drew). On the CPU a `torch.Generator` is seeded with its value.
    Returns tokens (n_cb, B) int32, row 0 zeros; with `return_logits`,
    (tokens, logits (n_cb-1, B, v) f32 before any Gumbel noise), for
    checking the kernel."""
    if not isinstance(seed, torch.Tensor) or seed.dim() > 1 \
            or seed.numel() != 1 or seed.dtype != torch.int32 \
            or seed.device != proj01.device:
        raise ValueError(f"resident_decode_frame: seed must be a () or (1,) "
                         f"int32 tensor on {proj01.device}")
    if proj01.device.type == "cpu":
        gen = None
        if temperature > 0.0:
            gen = torch.Generator().manual_seed(int(seed))
        toks, logits = resident_decode_frame_plain(res, args, proj01,
                                                   temperature, gen)
        return (toks, logits) if return_logits else toks
    if proj01.device.type != "cuda":
        raise ValueError(f"resident_decode_frame: unsupported device "
                         f"{proj01.device}")
    from csm_mlx_tpu_torch.ops import _build

    dcfg = args.decoder_config
    d, f = dcfg.hidden_size, dcfg.intermediate_size
    n_cb, v = args.n_audio_codebooks, args.n_audio_vocab
    kvd = dcfg.num_key_value_heads * dcfg.head_dim
    if proj01.dim() != 3 or proj01.shape[0] != 2 or proj01.shape[2] != d:
        raise ValueError(f"resident_decode_frame: proj01 "
                         f"{tuple(proj01.shape)}, want (2, B, {d})")
    b = proj01.shape[1]
    if not 1 <= b <= RESIDENT_MAX_BATCH:
        raise ValueError(f"resident_decode_frame: B = {b}; a call takes "
                         f"1..{RESIDENT_MAX_BATCH} rows")
    if proj01.dtype != torch.float32:
        raise ValueError(f"resident_decode_frame: proj01 is {proj01.dtype}, "
                         f"want float32")
    if temperature < 0.0:
        raise ValueError("resident_decode_frame: temperature < 0")
    dev = proj01.device
    _check_tables(res, args, dev)
    proj01 = proj01.contiguous()
    n_layers = len(res["layers"])
    v_pad = res["audio_head_q"].shape[1]
    grid = (torch.cuda.get_device_properties(dev).multi_processor_count
            * _BLOCKS_PER_SM)
    max_in = max(d, f)
    x = torch.empty((b, d), dtype=torch.float32, device=dev)
    q = torch.empty((b, d), dtype=torch.float32, device=dev)
    ao = torch.empty((b, d), dtype=torch.float32, device=dev)
    act = torch.empty((b, f), dtype=torch.float32, device=dev)
    xq = torch.empty((b, max_in), dtype=torch.int8, device=dev)
    aux = torch.empty((b, 2), dtype=torch.float32, device=dev)
    kc = torch.empty((n_layers, n_cb, b, kvd), dtype=torch.float32,
                     device=dev)
    vc = torch.empty_like(kc)
    part = torch.empty((grid, b, 2), dtype=torch.int32, device=dev)
    tokens = torch.empty((n_cb, b), dtype=torch.int32, device=dev)
    logits = torch.empty((n_cb - 1, b, v), dtype=torch.float32,
                         device=dev) if return_logits else None
    ptrs = [t.data_ptr() for lw in res["layers"] for t in lw]
    inv_t = 0.0 if temperature == 0.0 else 1.0 / temperature
    stamps = resident_decode_frame.stamps
    if stamps is not None:
        if stamps.dtype != torch.int64 or stamps.dim() != 2 \
                or stamps.shape[1] != 4 or stamps.device != dev \
                or not stamps.is_contiguous():
            raise ValueError("resident_decode_frame.stamps must be a "
                             f"contiguous (n, 4) int64 tensor on {dev}")
        stamps.zero_()
    code = _build.library().csm_resident_frame(
        (ctypes.c_void_p * len(ptrs))(*ptrs), n_layers,
        res["norm"].data_ptr(), res["rope_cs"].data_ptr(),
        res["audio_head_q"].data_ptr(), res["audio_head_s"].data_ptr(),
        res["embed_tab"].data_ptr(), proj01.data_ptr(), x.data_ptr(),
        q.data_ptr(), ao.data_ptr(), act.data_ptr(), xq.data_ptr(),
        aux.data_ptr(), kc.data_ptr(), vc.data_ptr(), part.data_ptr(),
        tokens.data_ptr(),
        None if logits is None else logits.data_ptr(), b,
        dcfg.num_attention_heads, dcfg.num_key_value_heads, dcfg.head_dim,
        d, f, n_cb, v, v_pad, dcfg.rms_norm_eps, dcfg.head_dim ** -0.5,
        inv_t, seed.data_ptr(), grid,
        None if stamps is None else stamps.data_ptr(),
        0 if stamps is None else stamps.shape[0], _build.stream_ptr(dev))
    _build.check(code, "csm_resident_frame")
    resident_decode_frame.launches += 1
    return (tokens, logits) if return_logits else tokens


launches.register(resident_decode_frame)
# A (n, 4) int64 CUDA tensor, or None. When set, each launch fills one
# record per phase: [start ns (release of the previous barrier, block 0),
# end of block 0's prologue ns (0 where a phase has none), latest arrival
# of any block at the phase's closing barrier ns, kind (PHASE_KINDS)]; a
# last record of kind "end" closes the call. The tokens do not change.
resident_decode_frame.stamps = None

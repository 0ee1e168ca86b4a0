"""Tensor parallelism of the serving forward over a mesh's "model" axis
(the port of what GSPMD and `csm_mlx_tpu/ops/quant.py::_quant_linear_tp`
do for the JAX package's sharded generation).

JAX places each tensor on the mesh and lets XLA insert the collectives.
The port runs one process a rank: `parallel.shard_model` keeps this rank's
shard of each tensor and records a `TensorParallel` on the model, and the
forward, run inside `scope(of(model))` (generation, the engine), reads it
here and writes its collectives out over the model-axis group:

- Attention by heads: q (and k, v, where the kv heads divide the axis)
  keep this rank's heads, the cache holds its kv heads, `o_proj` is
  in-sharded. Where the kv heads do not divide the axis, each rank keeps
  the kv heads of its q heads' GQA groups (its q heads must then lie in
  whole groups, or in one group); where the q heads do not divide it
  either, the stack's attention stays whole on every rank (`attn_layout`).
- The MLP by hidden columns: gate and up out-sharded, `down_proj`
  in-sharded (whole where the hidden width does not divide the axis).
- Vocabulary tables by rows where the vocabulary divides the axis (JAX's
  `_spec_fits`): a masked local lookup and an all-reduce for the
  embeddings (`embed`), local logits and an all-gather for the heads.

`linear(..., tp="in")` (ops/layers.py) sums the in-sharded products: a
local matmul (in fp32) and an all-reduce for dense weights; for W8A8 the
whole activation row is all-gathered, quantized once by kernel 1's
`w8a8_quant_rows`, each rank contracts its column range to raw int32
(`w8a8_partial`), the int32 sums all-reduce (exact), and `w8a8_fixup`
applies the fix-up once, so the output is bit-equal to the solo kernel.
Only plain dicts take part (`engages`: dense {"weight"} or W8A8/W4A8 int8
codes, as JAX's `_tp_engages`); affine and adapter-carrying linears stay
whole on every rank, and their output is cut to this rank's part.

At a model axis of 1 the same code runs, its collectives over one rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """The model axis of a sharded model: its process group, its size and
    this rank's index in it."""
    group: Any
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class AttnLayout:
    """This rank's attention heads: q heads [q_lo, q_lo + heads), kv heads
    [kv_lo, kv_lo + kv_heads) of the whole set."""
    heads: int
    q_lo: int
    kv_heads: int
    kv_lo: int


_STATE = threading.local()


def active() -> Optional[TensorParallel]:
    """The tensor parallelism of the forward running in this thread."""
    return getattr(_STATE, "tp", None)


def of(model) -> Optional[TensorParallel]:
    """The tensor parallelism `parallel.shard_model` recorded on a model
    (None for a model that was not placed on a mesh's model axis)."""
    return getattr(model, "tp", None)


@contextlib.contextmanager
def scope(tp: Optional[TensorParallel]) -> Iterator[None]:
    """Run the forward in this thread under `tp` (a sharded model's
    `of(model)`; None: unsharded)."""
    prev = active()
    _STATE.tp = tp
    try:
        yield
    finally:
        _STATE.tp = prev


def check_capture(tp: Optional[TensorParallel], mesh, flag: str) -> None:
    """Refuse to capture a CUDA graph whose collectives would run over
    gloo (which CUDA graphs cannot hold): the caller must ask for the
    eager path (`flag`) itself; it is never taken silently."""
    groups = [] if tp is None else [tp.group]
    if mesh is not None:
        groups += [mesh.get_group(a) for a in mesh.mesh_dim_names]
    if any(dist.get_backend(g) == "gloo" for g in groups):
        raise ValueError(f"a CUDA graph cannot hold gloo collectives; pass "
                         f"{flag} to run this mesh eagerly, or use NCCL")


def shard_of(full: int, tp: Optional[TensorParallel] = None
             ) -> Optional[Tuple[int, int]]:
    """(lo, size) of this rank's block of a dim of `full` split over the
    model axis; None when it stays whole (no TP, or `full` does not divide
    the axis)."""
    tp = tp or active()
    if tp is None or full % tp.size:
        return None
    size = full // tp.size
    return tp.rank * size, size


def attn_layout(cfg, tp: Optional[TensorParallel] = None
                ) -> Optional[AttnLayout]:
    """The local heads of a stack of config `cfg`, or None where its
    attention stays whole (no TP, heads indivisible, or kv groups that a
    rank's q heads would straddle)."""
    tp = tp or active()
    h, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    q = shard_of(h, tp)
    if q is None:
        return None
    q_lo, heads = q
    kv = shard_of(hkv, tp)
    if kv is not None:
        return AttnLayout(heads, q_lo, kv[1], kv[0])
    group = h // hkv
    if heads % group and group % heads:
        return None
    return AttnLayout(heads, q_lo, max(1, heads // group), q_lo // group)


def local_kv_heads(cfg) -> int:
    """The kv heads a rank caches for a stack of config `cfg`."""
    lay = attn_layout(cfg)
    return cfg.num_key_value_heads if lay is None else lay.kv_heads


def engages(params: dict) -> bool:
    """True for a linear that shards: a dense {"weight"} or plain W8A8 /
    W4A8 codes (int8) without adapters, as JAX's `_tp_engages` (dense
    weights partition under GSPMD there)."""
    keys = set(params)
    if keys == {"weight"}:
        return True
    return keys == {"weight_q", "scales", "biases"} \
        and params["weight_q"].dtype == torch.int8


def split_out(params: dict, y: torch.Tensor,
              parts: Sequence[Tuple[int, Optional[Tuple[int, int]]]]
              ) -> List[torch.Tensor]:
    """The parts of a (fused) out-sharded projection's output `y` on this
    rank; `parts` gives each part's whole width and its local (lo, size),
    or None where the part stays whole. A sharded linear's `y` holds the
    local widths side by side, as `parallel.shard_model` placed its rows;
    one that stays whole (`engages` false) gives the whole output, cut
    here to each part's local slice."""
    if engages(params):
        sizes = [full if local is None else local[1] for full, local in parts]
        return list(y.split(sizes, dim=-1))
    out, off = [], 0
    for full, local in parts:
        lo, size = (0, full) if local is None else local
        out.append(y[..., off + lo:off + lo + size])
        off += full
    return out


def all_reduce(x: torch.Tensor, tp: Optional[TensorParallel] = None
               ) -> torch.Tensor:
    """The sum of `x` over the model axis (in place on a contiguous x)."""
    x = x.contiguous()
    dist.all_reduce(x, group=(tp or active()).group)
    return x


def all_gather_last(x: torch.Tensor, tp: Optional[TensorParallel] = None
                    ) -> torch.Tensor:
    """The ranks' `x` side by side along the last dim, in rank order."""
    tp = tp or active()
    lead, w = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, w)
    out = gather_rows(rows, tp.group)
    return out.reshape(tp.size, rows.shape[0], w).permute(1, 0, 2).reshape(
        *lead, tp.size * w)


def embed(params: dict, ids: torch.Tensor, full_rows: int) -> torch.Tensor:
    """The rows `ids` of an embedding dict whose (vocab, D) table may be
    this rank's block of rows: a masked local lookup, then an all-reduce
    (each id is found on one rank and the others add zeros, so the sum is
    exact). A table that stays whole is looked up as it is."""
    from csm_mlx_tpu_torch.ops.layers import emb_table

    table = emb_table(params)
    local = shard_of(full_rows) if engages(params) else None
    if local is None:
        return table[ids]
    lo, size = local
    idx = ids - lo
    hit = (idx >= 0) & (idx < size)
    rows = table[torch.where(hit, idx, torch.zeros_like(idx))]
    return all_reduce(torch.where(hit[..., None], rows,
                                  torch.zeros((), dtype=rows.dtype,
                                              device=rows.device)))


def linear_in(params: dict, x: torch.Tensor) -> torch.Tensor:
    """An in-sharded linear: x (..., IN / n) is this rank's part of the
    input. Sharded weights: the partial products summed over the model
    axis (dense: an fp32 matmul and an all-reduce, one rounding to x.dtype
    after; W8A8: kernel 1's quantized row, int32 partials all-reduced,
    the fix-up once). A linear that stays whole gets the gathered row."""
    from csm_mlx_tpu_torch.ops.layers import linear

    tp = active()
    if not engages(params):
        return linear(params, all_gather_last(x))
    if "weight" in params:
        w = params["weight"]
        part = torch.matmul(x.float(), w.float().t()) \
            if x.dtype != torch.float32 else torch.matmul(x, w.t())
        return all_reduce(part).to(x.dtype)
    from csm_mlx_tpu_torch.ops import quant

    wq = params["weight_q"]
    xf = all_gather_last(x)
    lead = xf.shape[:-1]
    xq, aux = quant.w8a8_quant_rows(xf.reshape(-1, xf.shape[-1]))
    p = all_reduce(quant.w8a8_partial(xq, tp.rank * wq.shape[1], wq))
    y = quant.w8a8_fixup(p, aux, params["scales"], params["biases"], x.dtype)
    return y.reshape(*lead, -1)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `x` stacked along dim 0 in rank order (the rows of a
    data group)."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def diverged(x: torch.Tensor, tp: Optional[TensorParallel] = None
             ) -> torch.Tensor:
    """A () bool on x's device, the same on every rank of the model axis:
    True where the ranks' `x` differ (a sampled run without one generator
    seed across the group)."""
    got = gather_rows(x.reshape(1, -1), (tp or active()).group)
    return (got != got[:1]).any()

"""Device meshes and CSM sharding rules on `torch.distributed` (port of
`csm_mlx_tpu/parallel/mesh.py`).

JAX runs one program over a `jax.sharding.Mesh` and lets GSPMD insert the
collectives. The port runs one process per rank (multi-controller SPMD):
`create_mesh` returns a `torch.distributed.device_mesh.DeviceMesh` with
JAX's axis names, the placement functions return THIS rank's local shard,
and the code that uses them writes its collectives out (the trainers'
data axis, `parallel.pipeline`, `parallel.sequence`).

Axes (JAX's names):
- "data": the batch dimension; data-parallel and FSDP fine-tuning.
- "model": tensor parallelism: attention heads and the MLP hidden dim,
  vocab rows of the heads and embeddings (`_CSM_TP_RULES`).
- "pipe": pipeline stages (`parallel.pipeline`).
- "seq": the sequence of ring attention (`parallel.sequence`).

A placement is a `PartitionSpec` (`P`): one entry per dimension, an axis
name, a tuple of axis names or None (not sharded); `P()` replicates.
"""

from __future__ import annotations

import math
import os
import re
from datetime import timedelta
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from csm_mlx_tpu_torch.ops import tensor_parallel as tpar

GROUP_TIMEOUT = timedelta(minutes=10)  # a collective that waits longer fails


class PartitionSpec(tuple):
    """Axis names per dimension (None: not sharded); `P()` replicates. A
    dimension past the spec's length is not sharded."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _init_group(cpu: bool, timeout: timedelta = GROUP_TIMEOUT) -> None:
    """The default process group: from `torchrun`'s environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) when it is set, else
    one rank. NCCL on `cuda:LOCAL_RANK`, gloo on the CPU. A collective
    that waits longer than `timeout` fails."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kw: Dict[str, Any] = dict(init_method="env://")
    else:
        kw = dict(store=dist.HashStore(), rank=0, world_size=1)
    if cpu:
        dist.init_process_group("gloo", timeout=timeout, **kw)
        return
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", timeout=timeout, device_id=device, **kw)


def create_mesh(shape: Optional[Dict[str, int]] = None,
                devices: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh over every rank of the default process group. Default:
    one "data" axis over the whole world.

    create_mesh({"data": 2, "model": 4}) lays "model" innermost, as JAX
    does: ranks 4d..4d+3 share data coordinate d.

    `devices`: None for the card (each rank on `cuda:LOCAL_RANK` over NCCL;
    without a GPU this raises), "cpu" for CPU ranks over gloo. The default
    group is initialised here when it is not yet: from `torchrun`'s
    environment, or as a one-rank group without it. A group the caller
    initialised is used as it is, with its backend.
    """
    if devices not in (None, "cpu"):
        raise ValueError(f"devices must be None or 'cpu', not "
                         f"{devices!r}: each rank is a process and runs on "
                         f"its own device")
    cpu = devices == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is visible; pass devices="cpu" '
                           'for a mesh of CPU ranks')
    if not dist.is_initialized():
        _init_group(cpu)
    n_ranks = dist.get_world_size()
    if shape is None:
        shape = {"data": n_ranks}
    sizes = list(shape.values())
    n = math.prod(sizes)
    if n != n_ranks:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have "
                         f"{n_ranks}")
    return DeviceMesh("cpu" if cpu else "cuda",
                      torch.arange(n).reshape(sizes),
                      mesh_dim_names=tuple(shape))


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """`obj` (any picklable value) from global rank `src` on every rank of
    the default process group: each rank passes its own, and gets the
    sender's. Over NCCL the bytes go through this rank's current device."""
    box = [obj]
    device = None
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    dist.broadcast_object_list(box, src=src, device=device)
    return box[0]


def is_main_rank() -> bool:
    """True on rank 0 of the default process group, and without one: the
    rank that writes checkpoints and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: size}, JAX's `mesh.shape`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# (path regex, spec): first match wins. Linear weights are (out, in).
_CSM_TP_RULES: Tuple[Tuple[str, P], ...] = (
    # attention: heads (out dim of q/k/v, in dim of o); the fused variants
    # shard the concatenated out dim
    (r".*self_attn\.(q_proj|k_proj|v_proj|qkv_proj)\.weight$",
     P("model", None)),
    (r".*self_attn\.o_proj\.weight$", P(None, "model")),
    # mlp: the hidden dim
    (r".*mlp\.(gate_proj|up_proj|gateup_proj)\.weight$", P("model", None)),
    (r".*mlp\.down_proj\.weight$", P(None, "model")),
    # W8A8 layouts: out-sharded projections shard their per-channel scales
    # and biases with the codes; in-sharded ones (o, down) keep them
    # replicated (the fix-up applies once after the int32 sum)
    (r".*self_attn\.(q_proj|k_proj|v_proj|qkv_proj)\."
     r"(weight_q|scales|biases)$", P("model", None)),
    (r".*self_attn\.o_proj\.weight_q$", P(None, "model")),
    (r".*mlp\.(gate_proj|up_proj|gateup_proj)\.(weight_q|scales|biases)$",
     P("model", None)),
    (r".*mlp\.down_proj\.weight_q$", P(None, "model")),
    (r"codebook0_head\.(weight_q|scales|biases)$", P("model", None)),
    # output heads: vocab
    (r"codebook0_head\.weight$", P("model", None)),
    (r"audio_head$", P(None, None, "model")),
    # embeddings: vocab rows
    (r"(text|audio)_embeddings\.weight$", P("model", None)),
    # norms, projection, everything else: replicated
    (r".*", P()),
)


def map_tree(fn: Callable[[str, Any], Any], tree: Any, prefix: str = ""
             ) -> Any:
    """The tree of fn(dotted path, leaf) over nested dicts and lists, with
    the structure of `tree`. Derived "_"-prefixed entries are leaves like
    any other (the spec tree has the params' structure), and so is a
    `PartitionSpec`."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = [map_tree(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(prefix[:-1], tree)


def _tp_spec(path: str, tensor_parallel: bool) -> P:
    """The spec of the first TP rule that matches `path`."""
    if not tensor_parallel:
        return P()
    return next(s for pattern, s in _CSM_TP_RULES if re.search(pattern, path))


def csm_param_spec(params: Any, tensor_parallel: bool = True) -> Any:
    """The spec tree of CSM params (all replicated if not TP)."""
    return map_tree(lambda path, _: _tp_spec(path, tensor_parallel), params)


def data_parallel_spec(batch: Any) -> Any:
    """P("data") on the leading dim of every array leaf; scalars
    replicate."""
    return map_tree(lambda _, x: P() if getattr(x, "ndim", 1) == 0
                    else P("data"), batch)


# -- FSDP (ZeRO-3-style fully-sharded data parallel) ---------------------
#
# Parameters and optimizer state are stored sharded over "data" (the
# largest dim of each tensor). The trainer all-gathers the shards for a
# step and reduce-scatters the gradients (finetune/trainer.py), so each
# rank holds ~1/n of the parameters and of their AdamW moments.

_FSDP_MIN_BYTES = 1 << 16  # replicate small tensors (norm scales, biases)


def fsdp_leaf_spec(x: Any, mesh: DeviceMesh, axis: str = "data") -> P:
    """Shape-based FSDP rule for ONE tensor: shard the largest dim that the
    axis divides (ties to the leading dim); replicate small or indivisible
    tensors. Shape-based, so a parameter and its AdamW moments get the
    same spec."""
    ndim = getattr(x, "ndim", 0)
    size = math.prod(x.shape) if ndim else 1
    nbytes = size * getattr(getattr(x, "dtype", None), "itemsize", 4)
    if ndim == 0 or nbytes < _FSDP_MIN_BYTES:
        return P()
    n = axis_sizes(mesh).get(axis, 1)
    for dim in sorted(range(ndim), key=lambda d: (-x.shape[d], d)):
        if x.shape[dim] % n == 0:
            return P(*(axis if d == dim else None for d in range(ndim)))
    return P()


def fsdp_param_spec(params: Any, mesh: DeviceMesh, axis: str = "data"
                    ) -> Any:
    """The spec tree of `fsdp_leaf_spec` over every leaf."""
    return map_tree(lambda _, x: fsdp_leaf_spec(x, mesh, axis), params)


def _spec_fits(x, spec: P, mesh: DeviceMesh) -> bool:
    """True iff every sharded dim of x divides the mesh axes assigned to it
    and every named axis is in the mesh: a TP spec on a data-only mesh, or
    an odd vocab, falls back to replication rather than raise."""
    sizes = axis_sizes(mesh)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if any(a not in sizes for a in axes):
            return False
        div = math.prod(sizes[a] for a in axes)
        if dim >= getattr(x, "ndim", 0) or x.shape[dim] % div != 0:
            return False
    return True


def _shard_slot(spec_dim, mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of one spec entry: a
    tuple of axes counts row-major, the first axis outermost."""
    axes = (spec_dim,) if isinstance(spec_dim, str) else tuple(spec_dim)
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def local_shard(x: torch.Tensor, spec: P, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of `x` under `spec` (a copy when sharded, so the
    whole tensor can be freed; `x` itself when replicated)."""
    out = x
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        idx, n = _shard_slot(axes, mesh)
        step = x.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out if out is x else out.clone()


def _sharded_dim(spec: P) -> Optional[Tuple[int, str]]:
    """(dim, axis) of a spec that shards one dim over one axis, else None
    (replicated); other specs raise."""
    named = [(d, a) for d, a in enumerate(spec) if a is not None]
    if not named:
        return None
    if len(named) > 1 or not isinstance(named[0][1], str):
        raise ValueError(f"{spec} shards over more than one axis")
    return named[0]


def all_gather_leaf(local: torch.Tensor, spec: P, mesh: DeviceMesh
                    ) -> torch.Tensor:
    """The whole tensor from every rank's `local_shard` under a spec that
    shards at most one dim over one axis (an FSDP spec)."""
    found = _sharded_dim(spec)
    if found is None:
        return local
    dim, axis = found
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    rows = torch.empty((n * local.shape[0],) + tuple(local.shape[1:]),
                       dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(rows, local.contiguous(), group=group)
    if dim == 0:
        return rows
    return torch.cat(rows.chunk(n), dim=dim)


def reduce_scatter_leaf(full: torch.Tensor, spec: P, mesh: DeviceMesh,
                        axis: str = "data") -> torch.Tensor:
    """This rank's block, under `spec`, of the sum over the ranks of `axis`
    of `full` (each rank's whole tensor): FSDP's sharded gradient. A
    replicated spec all-reduces the whole tensor (in place when `full` is
    contiguous)."""
    found = _sharded_dim(spec)
    if found is None:
        out = full.contiguous()
        dist.all_reduce(out, group=mesh.get_group(axis))
        return out
    dim, axis = found
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    out_shape = list(full.shape)
    out_shape[dim] //= n
    blocks = full.contiguous() if dim == 0 else \
        torch.stack(full.chunk(n, dim=dim))
    out = torch.empty(out_shape, dtype=full.dtype, device=full.device)
    dist.reduce_scatter_tensor(
        out, blocks.reshape([n * out_shape[0]] + out_shape[1:]), group=group)
    return out


def shard_params_fsdp(params: Any, mesh: DeviceMesh, axis: str = "data"
                      ) -> Any:
    """This rank's FSDP shards of params (or of any tree of tensors, such as
    optimizer state) over `axis`."""
    return map_tree(lambda _, x: local_shard(x, fsdp_leaf_spec(x, mesh, axis),
                                             mesh), params)


def shard_params(params: Any, mesh: DeviceMesh, tensor_parallel: bool = True
                 ) -> Any:
    """This rank's shards of params under the TP rules. Tensors whose
    sharded dims don't divide the mesh axis (the 2051-wide vocab heads on a
    model axis of 4), or whose axis the mesh lacks, stay whole."""
    def one(path, x):
        spec = _tp_spec(path, tensor_parallel)
        return local_shard(x, spec if _spec_fits(x, spec, mesh) else P(),
                           mesh)

    return map_tree(one, params)


def shard_batch(batch: Any, mesh: DeviceMesh) -> Any:
    """This rank's rows (dim 0, over "data") of every array of `batch`."""
    return map_tree(lambda _, x: local_shard(x, P("data"), mesh)
                    if torch.is_tensor(x) else
                    _rows(x, *_shard_slot("data", mesh)), batch)


def _rows(x, idx: int, n: int):
    step = len(x) // n
    return x[idx * step:(idx + 1) * step]


def _out_rows(d: dict, parts) -> dict:
    """A linear dict cut to this rank's output rows: per part (its whole
    width, its local (lo, size) or None for whole), the codes or weight
    rows and W8A8's per-channel scales and biases alike. A dict that does
    not shard (`ops.tensor_parallel.engages`) stays whole."""
    if not tpar.engages(d):
        return d
    out = {}
    for key, t in d.items():
        pieces, off = [], 0
        for full, local in parts:
            lo, size = (0, full) if local is None else local
            pieces.append(t[off + lo:off + lo + size])
            off += full
        out[key] = torch.cat(pieces).contiguous()
    return out


def _in_cols(d: dict, lo: int, size: int) -> dict:
    """A linear dict cut to this rank's input columns (the weight or the
    int8 codes; W8A8's per-channel scales and biases stay whole, the
    fix-up applies once after the int32 sum)."""
    if not tpar.engages(d):
        return d
    return {key: t[:, lo:lo + size].contiguous()
            if key in ("weight", "weight_q") else t for key, t in d.items()}


def _place_layer(layer: dict, cfg, tp) -> None:
    """One transformer layer's TP shards, aligned to heads and to the MLP's
    hidden columns (`ops.tensor_parallel`), in place."""
    attn, mlp = layer["self_attn"], layer["mlp"]
    lay = tpar.attn_layout(cfg, tp)
    if lay is not None:
        h, hkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        kv = (hkv * hd, (lay.kv_lo * hd, lay.kv_heads * hd))
        parts = ((h * hd, (lay.q_lo * hd, lay.heads * hd)), kv, kv)
        if "qkv_proj" in attn:
            attn["qkv_proj"] = _out_rows(attn["qkv_proj"], parts)
        else:
            for name, part in zip(("q_proj", "k_proj", "v_proj"), parts):
                attn[name] = _out_rows(attn[name], (part,))
        attn["o_proj"] = _in_cols(attn["o_proj"], lay.q_lo * hd,
                                  lay.heads * hd)
    f = cfg.intermediate_size
    local = tpar.shard_of(f, tp)
    if local is not None:
        for name in ("gateup_proj", "gate_proj", "up_proj"):
            if name in mlp:
                mlp[name] = _out_rows(mlp[name], ((f, local),) * (
                    2 if name == "gateup_proj" else 1))
        mlp["down_proj"] = _in_cols(mlp["down_proj"], *local)


def shard_model(model: Any, mesh: DeviceMesh, tensor_parallel: bool = True
                ) -> Any:
    """Place a CSM for serving on `mesh`, in place: keep this rank's
    tensor-parallel shards over "model" and record the tensor parallelism
    on the model (`model.tp`, an `ops.tensor_parallel.TensorParallel`)
    for generation, the engine and the servers, which then run with
    `mesh=`.

    The placement is aligned to what a local forward can run, where
    `shard_params` keeps JAX's device blocks (the trainers' placement):
    attention by heads (a fused `qkv_proj` split into q, k and v, each cut
    to this rank's heads, and put back together; where the kv heads do not
    divide the axis, the kv heads of this rank's GQA groups; where the q
    heads do not divide it either, that stack's attention whole), the MLP
    by hidden columns (`gateup_proj` likewise), and the vocabulary tables
    by rows under JAX's rules, whole where the vocabulary does not divide
    the axis. W8A8 codes shard with their per-channel scales and biases;
    affine and adapter-carrying linears stay whole, as in JAX. A mesh
    without a "model" axis, or tensor_parallel=False, keeps every tensor
    whole (model.tp None).

    Derived "_"-prefixed entries (kernel 3's tables, which assume the
    whole decoder on one device) are dropped.
    """
    p = model.params
    for k in [k for k in p if isinstance(k, str) and k.startswith("_")]:
        del p[k]
    sizes = axis_sizes(mesh)
    model.tp = None
    if not tensor_parallel or "model" not in sizes:
        return model
    group = mesh.get_group("model")
    tp = tpar.TensorParallel(group, sizes["model"],
                             mesh.get_local_rank("model"))
    if dist.get_rank(group) != tp.rank:
        raise RuntimeError("the model axis' group ranks its members out of "
                           "mesh order")
    args = model.args
    for key, cfg in (("backbone", args.backbone_config),
                     ("decoder", args.decoder_config)):
        for layer in p.get(key, {}).get("layers", []):
            _place_layer(layer, cfg, tp)
    n_audio = args.n_audio_vocab
    for key, full in (("text_embeddings", args.n_text_vocab),
                      ("audio_embeddings", n_audio * args.n_audio_codebooks),
                      ("codebook0_head", n_audio)):
        local = tpar.shard_of(full, tp)
        if isinstance(p.get(key), dict) and local is not None:
            p[key] = _out_rows(p[key], ((full, local),))
    local = tpar.shard_of(n_audio, tp)
    if torch.is_tensor(p.get("audio_head")) and local is not None:
        p["audio_head"] = p["audio_head"].narrow(2, *local).contiguous()
    model.tp = tp
    getattr(model, "frame_steps", {}).clear()
    return model

"""GPipe pipeline parallelism for the backbone layer stack (port of
`csm_mlx_tpu/parallel/pipeline.py`).

The layers split into contiguous stages over the "pipe" mesh axis; a
microbatched forward streams activations stage to stage by point-to-point
sends, and gradients flow back the same way.

- Storage: every per-layer leaf is stacked to (n_stages, per_stage, ...)
  (`stack_pipeline_params`) and each "pipe" rank keeps its stage's
  (1, per_stage, ...) slice (`shard_pipeline_params`).
- Schedule: `n_micro + n_stages - 1` ticks. At tick t stage s runs
  microbatch t - s: stage 0 takes it from the input, the others receive
  it from stage s - 1 (`_Recv`), and every stage but the last sends its
  output on (`_Send`). A stage's bubble ticks run nothing (JAX computes
  and discards them: one SPMD program). Each rank holds every
  microbatch's positions and mask, so a stage indexes microbatch t - s's
  own rather than receiving them with the activations.
- Gradients: `_Send`'s backward receives the activation's gradient from
  the next stage, `_Recv`'s sends it to the previous one. Autograd runs
  each rank's backward from the newest microbatch to the oldest, so the
  two sides meet in the same order.
- The last stage's output is broadcast to every pipe rank (`_Broadcast`,
  JAX's psum). Every rank then holds the same output and computes the
  same loss (SPMD); the last stage backpropagates its own cotangent, and
  the broadcast's backward on the other ranks starts their stages'
  backward (the sends' gradients).

The bubble fraction is (n_stages - 1) / (n_micro + n_stages - 1): pick
n_micro >= ~4 x n_stages for training efficiency.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from csm_mlx_tpu_torch.config import LlamaConfig
from csm_mlx_tpu_torch.models.llama import llama_layer
from csm_mlx_tpu_torch.ops.layers import rms_norm
from csm_mlx_tpu_torch.parallel.mesh import axis_sizes, map_tree


def _leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    map_tree(lambda _, x: out.append(x), tree)
    return out


def _zip_map(fn, trees: Sequence[Any]) -> Any:
    """The tree of fn(*leaves) over trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_zip_map(fn, [t[i] for t in trees]) for i in range(len(first))]
    return fn(*trees)


def stack_pipeline_params(layers: Sequence[Any], n_stages: int) -> Any:
    """Per-layer params -> per-stage storage: every leaf becomes
    (n_stages, layers_per_stage, *leaf.shape). Requires
    len(layers) % n_stages == 0 (contiguous equal stages)."""
    n_layers = len(layers)
    if n_layers % n_stages != 0:
        raise ValueError(
            f"{n_layers} layers do not split into {n_stages} equal stages")
    per = n_layers // n_stages

    def stk(*leaves):
        a = torch.stack(leaves)
        return a.reshape((n_stages, per) + tuple(a.shape[1:]))

    return _zip_map(stk, list(layers))


def shard_pipeline_params(stacked: Any, mesh: DeviceMesh) -> Any:
    """This "pipe" rank's stage of stage-stacked params: each leaf's
    (1, per_stage, ...) slice (a copy, so the whole stack can be freed;
    differentiable)."""
    idx = mesh.get_local_rank("pipe")
    return map_tree(lambda _, a: a[idx:idx + 1].clone(), stacked)


def _stage_apply(stage_params: Any, cfg: LlamaConfig, x: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor,
                 positions: torch.Tensor, mask_bias: torch.Tensor,
                 remat: bool) -> torch.Tensor:
    """One stage's layers_per_stage layers, each `models.llama`'s training
    layer (remat per layer, with the LoRA dropout masks replayed)."""
    for i in range(_leaves(stage_params)[0].shape[0]):
        x = llama_layer(map_tree(lambda _, a: a[i], stage_params), cfg, x,
                        cos, sin, positions, mask_bias, remat=remat)
    return x


class _Pipe:
    """The "pipe" axis's group, this rank's stage and its neighbours."""

    def __init__(self, mesh: DeviceMesh):
        self.group = mesh.get_group("pipe")
        self.n = axis_sizes(mesh)["pipe"]
        self.idx = mesh.get_local_rank("pipe")
        self.last = dist.get_global_rank(self.group, self.n - 1)
        self.prev = (dist.get_global_rank(self.group, self.idx - 1)
                     if self.idx > 0 else None)
        self.next = (dist.get_global_rank(self.group, self.idx + 1)
                     if self.idx < self.n - 1 else None)


class _Send(torch.autograd.Function):
    """Send y to the next stage; the returned token carries the gradient
    path: its backward receives y's gradient from that stage."""

    @staticmethod
    def forward(ctx, y, pipe: _Pipe):
        dist.send(y.contiguous(), pipe.next, group=pipe.group)
        ctx.pipe = pipe
        ctx.spec = (y.shape, y.dtype, y.device)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.spec
        grad = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(grad, ctx.pipe.next, group=ctx.pipe.group)
        return grad, None


class _Recv(torch.autograd.Function):
    """The previous stage's activation, of `spec` (shape, dtype, device);
    its backward sends the gradient back to that stage. `anchor` is any
    tensor that needs a gradient, so that autograd records the node."""

    @staticmethod
    def forward(ctx, anchor, spec, pipe: _Pipe):
        shape, dtype, device = spec
        buf = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(buf, pipe.prev, group=pipe.group)
        ctx.pipe = pipe
        return buf

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), ctx.pipe.prev, group=ctx.pipe.group)
        return None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's output on every pipe rank. Backward: the last
    stage keeps its own cotangent (every rank computed the same loss); the
    other ranks pass a zero gradient to their send tokens, which starts
    their stages' backward."""

    @staticmethod
    def forward(ctx, out, pipe: _Pipe, *tokens):
        ctx.n_tokens = len(tokens)
        ctx.owner = pipe.next is None
        result = out.clone() if ctx.owner else torch.empty_like(out)
        dist.broadcast(result, pipe.last, group=pipe.group)
        return result

    @staticmethod
    def backward(ctx, grad):
        tokens = [grad.new_zeros(())] * ctx.n_tokens
        return (grad if ctx.owner else None, None, *tokens)


def pipeline_forward(
    stacked: Any,
    cfg: LlamaConfig,
    embeds: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
    mask_bias: torch.Tensor,
    mesh: DeviceMesh,
    n_micro: int,
    norm: Optional[Any] = None,
    remat: bool = False,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """Run the layer stack as a pipeline over the mesh's "pipe" axis.

    Args:
      stacked: this rank's stage (`shard_pipeline_params`).
      embeds: (B, S, D), the same on every rank; B splits into n_micro
        microbatches.
      cos/sin/positions/mask_bias: as `llama_forward` (positions (1, S) or
        (B, S), mask_bias (1|B, 1, S, S)).
      norm: optional final-norm params applied after the pipeline.
      remat: each layer recomputed in the backward pass (JAX checkpoints
        the whole stage; the result is the same).
      data_axis: a second mesh axis for 2-D PP x DP: each microbatch's rows
        split further over it, and each (pipe, data) rank runs its stage
        on its 1/n_data of them.

    Returns the hidden states on every pipe rank: (B, S, D), or with
    `data_axis` this rank's (B / n_data, S, D) rows, microbatch by
    microbatch (rows m*mb + d*mb/n_data ... of microbatch m at data
    coordinate d). The gradient of `embeds` lands on the first stage.
    """
    pipe = _Pipe(mesh)
    b = embeds.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible into {n_micro} microbatches")
    mb = b // n_micro
    rows = slice(0, mb)
    if data_axis is not None:
        n_data = axis_sizes(mesh)[data_axis]
        if mb % n_data != 0:
            raise ValueError(f"microbatch {mb} not divisible over "
                             f"{data_axis}={n_data}")
        step = mb // n_data
        d = mesh.get_local_rank(data_axis)
        rows = slice(d * step, (d + 1) * step)

    def micro(t: torch.Tensor, m: int) -> torch.Tensor:
        """Microbatch m's rows (this rank's), or t itself when it has no
        batch dim to split (a (1, ...) tensor)."""
        if t.shape[0] != b or b == 1:
            return t
        return t[m * mb:(m + 1) * mb][rows]

    stage_params = map_tree(lambda _, a: a[0], stacked)

    anchor = embeds if embeds.requires_grad else \
        next((a for a in _leaves(stage_params) if a.requires_grad), embeds)
    outs: List[torch.Tensor] = []
    tokens: List[torch.Tensor] = []
    shape = micro(embeds, 0).shape
    for t in range(n_micro + pipe.n - 1):
        m = t - pipe.idx
        if not 0 <= m < n_micro:
            continue  # a bubble tick of this stage
        if pipe.idx == 0:
            x = micro(embeds, m)
        else:
            x = _Recv.apply(anchor, (shape, embeds.dtype, embeds.device),
                            pipe)
        y = _stage_apply(stage_params, cfg, x, cos, sin, micro(positions, m),
                         micro(mask_bias, m), remat)
        if pipe.next is not None:
            tokens.append(_Send.apply(y, pipe))
        else:
            outs.append(y)
    if pipe.next is None:
        out = torch.cat(outs)
    else:
        out = torch.empty((shape[0] * n_micro,) + tuple(shape[1:]),
                          dtype=embeds.dtype, device=embeds.device)
    out = _Broadcast.apply(out, pipe, *tokens)
    if norm is not None:
        out = rms_norm(norm, out, cfg.rms_norm_eps)
    return out

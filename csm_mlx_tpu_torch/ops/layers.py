"""Primitive layers as plain functions over parameter dicts (port of
`csm_mlx_tpu/ops/layers.py`).

Parameters keep the checkpoint layout: Linear weights are (out, in),
embeddings (vocab, dim). `linear` dispatches on the dict itself: one that
carries `weight_q` runs the quantized path (`ops.quant.quant_linear`), one
that carries `lora_a` adds the low-rank adapter term, one that carries
`dora_m` renormalizes each row of the adapted weight (DoRA). Norms
accumulate in fp32 and cast back.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# Training-time LoRA dropout: a seed drawn from the trainer's generator and
# a count of the dropout calls made under it. Call c draws its mask from a
# generator seeded with (seed, c), so a forward replayed for activation
# checkpointing (`dropout_snapshot` / `dropout_replay`) draws the same masks.
# Outside a `lora_dropout_rng` scope dropout is the identity.
_DROPOUT_CTX: Dict[str, Optional[int]] = {"seed": None, "count": 0}


@contextmanager
def lora_dropout_rng(generator: Optional[torch.Generator], stream: int = 0):
    """Enable LoRA dropout for `linear` calls inside this scope, with masks
    drawn from `generator` (None: dropout stays off). `stream` is mixed
    into the seed: the ranks of a data-parallel step advance one generator
    alike and draw independent masks for their rows."""
    prev = dict(_DROPOUT_CTX)
    seed = None
    if generator is not None:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device).item())
        seed = (seed ^ (stream * 0x9E3779B97F4A7C15)) % 2 ** 62
    _DROPOUT_CTX.update(seed=seed, count=0)
    try:
        yield
    finally:
        _DROPOUT_CTX.update(prev)


def dropout_snapshot() -> Dict[str, Optional[int]]:
    """The dropout state before a checkpointed block (see `dropout_replay`)."""
    return dict(_DROPOUT_CTX)


@contextmanager
def dropout_replay(snapshot: Dict[str, Optional[int]]):
    """Run a block under the dropout state of `snapshot`, so that its
    recomputation in the backward pass draws the masks of its first run.
    On exit the live state is restored, advanced past the calls the block
    made when the snapshot is the live state (the first run)."""
    prev = dict(_DROPOUT_CTX)
    _DROPOUT_CTX.update(snapshot)
    try:
        yield
    finally:
        used = _DROPOUT_CTX["count"] - snapshot["count"]
        _DROPOUT_CTX.update(prev)
        if prev == snapshot:
            _DROPOUT_CTX["count"] += used


def _maybe_dropout(x: torch.Tensor, rate) -> torch.Tensor:
    seed = _DROPOUT_CTX["seed"]
    if seed is None:
        return x
    _DROPOUT_CTX["count"] += 1
    gen = torch.Generator(device=x.device)
    gen.manual_seed((seed + 1_000_003 * _DROPOUT_CTX["count"]) % (2 ** 63))
    # scaled by the rate leaf itself where it is one, so that it takes a
    # gradient as in JAX (the trainer's clipping norm counts it)
    tensor = torch.is_tensor(rate)
    keep = 1.0 - float(rate.detach() if tensor else rate)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    scale = (1.0 - rate.float()).to(x.dtype) if tensor else keep
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def _lora_scale(params: Params):
    return params["lora_scale"] if "lora_scale" in params else 1.0


def _lora_delta(params: Params, x: torch.Tensor) -> torch.Tensor:
    """scale * ((dropout(x) @ A^T) @ B^T): factored, never forms B A."""
    if "lora_dropout" in params:
        x = _maybe_dropout(x, params["lora_dropout"])
    z = torch.matmul(x, params["lora_a"].to(x.dtype).t())
    z = torch.matmul(z, params["lora_b"].to(x.dtype).t())
    return _lora_scale(params) * z


def linear(params: Params, x: torch.Tensor,
           tp: Optional[str] = None) -> torch.Tensor:
    """y = x @ W^T (+ b), W stored (out, in); LoRA adds the adapter term,
    DoRA renormalizes each row of the adapted weight.

    `tp` is the caller's tensor-parallel layout hint, as in JAX: "out"
    (output channels shard over the model axis: the local rows run as
    they are) or "in" (the contracted dim shards: under a sharded model's
    `ops.tensor_parallel.scope`, x is this rank's part and the partial
    products are summed over the model axis, `tensor_parallel.linear_in`).
    """
    if tp == "in":
        from csm_mlx_tpu_torch.ops import tensor_parallel

        if tensor_parallel.active() is not None:
            return tensor_parallel.linear_in(params, x)
    if "weight_q" in params:
        if "dora_m" in params:
            raise ValueError(
                "quantized DoRA leaves are unsupported: the per-row "
                "renormalization needs the dense weight (fuse_lora before "
                "quantizing)")
        from csm_mlx_tpu_torch.ops.quant import quant_linear

        y = quant_linear(params, x)
        if "lora_a" in params:
            y = y + _lora_delta(params, x).to(y.dtype)
        return y
    w = params["weight"]
    if "dora_m" in params:
        from csm_mlx_tpu_torch.finetune.lora import effective_weight

        if _DROPOUT_CTX["seed"] is not None and "lora_dropout" in params:
            # dropout on the adapter branch only; each row renormalized
            # from the clean adapted weight
            adapted = w.float() + _lora_scale(params) * (
                params["lora_b"] @ params["lora_a"]).float()
            norm = torch.clamp(torch.linalg.vector_norm(adapted, dim=-1),
                               min=1e-6)
            gain = (params["dora_m"].float() / norm).to(x.dtype)
            y = torch.matmul(x, w.to(x.dtype).t())
            y = (y + _lora_delta(params, x).to(y.dtype)) * gain
        else:
            y = torch.matmul(x, effective_weight(params).to(x.dtype).t())
    else:
        y = torch.matmul(x, w.to(x.dtype).t())
        if "lora_a" in params:
            y = y + _lora_delta(params, x).to(y.dtype)
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def emb_table(params: Params) -> torch.Tensor:
    """The embedding table stored (vocab, dim), with its LoRA adapter
    folded in when it carries one."""
    w = params["weight"]
    if "lora_a" in params:
        w = w + (_lora_scale(params)
                 * (params["lora_b"] @ params["lora_a"])).to(w.dtype)
    return w


def rms_norm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """weight * x / rms(x), rms taken in fp32."""
    xf = x.float()
    rrms = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * rrms).to(x.dtype) * params["weight"].to(x.dtype)


def swiglu_mlp(params: Dict[str, Params], x: torch.Tensor,
               hidden: Optional[int] = None) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)); fused `gateup_proj` runs gate and up as
    one wide matmul (see models.llama.fuse_layer_weights). `hidden`, the
    stack's intermediate size, is needed only under a sharded model's
    tensor parallelism: the hidden columns then shard over the model axis
    where they divide it (gate, up out-sharded; down in-sharded)."""
    from csm_mlx_tpu_torch.ops import tensor_parallel

    local = tensor_parallel.shard_of(hidden) if hidden else None
    if local is None:
        if "gateup_proj" in params:
            gu = linear(params["gateup_proj"], x)
            f = gu.shape[-1] // 2
            gate, up = gu[..., :f], gu[..., f:]
        else:
            gate = linear(params["gate_proj"], x)
            up = linear(params["up_proj"], x)
        return linear(params["down_proj"], F.silu(gate) * up)
    part = (hidden, local)
    if "gateup_proj" in params:
        gate, up = tensor_parallel.split_out(
            params["gateup_proj"], linear(params["gateup_proj"], x, "out"),
            (part, part))
    else:
        (gate,) = tensor_parallel.split_out(
            params["gate_proj"], linear(params["gate_proj"], x, "out"),
            (part,))
        (up,) = tensor_parallel.split_out(
            params["up_proj"], linear(params["up_proj"], x, "out"), (part,))
    return linear(params["down_proj"], F.silu(gate) * up, "in")

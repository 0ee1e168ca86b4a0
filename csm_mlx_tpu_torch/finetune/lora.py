"""LoRA / DoRA adapters over parameter trees (port of
`csm_mlx_tpu/finetune/lora.py`).

An adapted Linear's params dict gains `lora_a` (rank, in), `lora_b`
(out, rank), `lora_scale` (fp32) and, for DoRA, `dora_m` (out,);
`ops.layers.linear` serves such dicts directly:

  effective W = W + scale * B @ A                        (LoRA)
  effective W = m * (W + scale * B A) / ||.||_row        (DoRA)

`linear_to_lora_layers(model, config)` rewrites matching leaves in place
(keys as in the reference: q/k/v/o + gate/up/down, "attn" expands to
them, in backbone and decoder). `trainable_filter` selects the paths that
end in lora_a / lora_b / dora_m. Adapter files keep the reference format:
`adapter_config.json` + `adapters.safetensors` in reference names.
"""

from __future__ import annotations

import json
import math
import re
import types
from pathlib import Path
from typing import Any, Dict, List

import torch

from csm_mlx_tpu_torch.models.csm import CSM

DEFAULT_KEYS = [
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
    "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj",
]

TRAINABLE_RE = re.compile(r"\.(lora_a|lora_b|dora_m)$")


def trainable_filter(path: str) -> bool:
    """Path predicate of the adapter leaves (optimizer, trainable-only
    checkpoints)."""
    return bool(TRAINABLE_RE.search(path))


def effective_weight(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The adapted weight of a (possibly) LoRA/DoRA dict, computed in fp32
    and cast back to the base weight's dtype."""
    w0 = p["weight"]
    if "lora_a" not in p:
        return w0
    scale = p["lora_scale"] if "lora_scale" in p else 1.0
    if isinstance(scale, torch.Tensor) and scale.dim() > 0:
        scale = scale[..., None, None]  # stacked (L,) -> (L, 1, 1)
    delta = p["lora_b"].float() @ p["lora_a"].float()
    w = w0.float() + scale * delta
    if "dora_m" in p:
        norm = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        w = p["dora_m"].float()[..., None] * w / torch.clamp(norm, min=1e-6)
    return w.to(w0.dtype)


def _adapt_leaf(p: Dict[str, Any], rank: int, scale: float, dropout: float,
                use_dora: bool, generator: torch.Generator) -> None:
    w = p["weight"]
    *lead, out_dim, in_dim = w.shape
    a = torch.rand((*lead, rank, in_dim), generator=generator,
                   device=w.device, dtype=torch.float32) * 2.0 - 1.0
    p["lora_a"] = (a * (1.0 / math.sqrt(in_dim))).to(w.dtype)
    p["lora_b"] = torch.zeros((*lead, out_dim, rank), dtype=w.dtype,
                              device=w.device)
    p["lora_scale"] = torch.full(tuple(lead), scale, dtype=torch.float32,
                                 device=w.device)
    if use_dora:
        p["dora_m"] = torch.linalg.vector_norm(w.float(), dim=-1).to(w.dtype)
    if dropout and dropout > 0.0:
        # dropout on the adapter input, live only in a lora_dropout_rng
        # scope (the trainers open one); the identity at inference
        p["lora_dropout"] = torch.tensor(dropout, dtype=torch.float32,
                                         device=w.device)


def linear_to_lora_layers(model, config: Dict, use_dora: bool = False) -> None:
    """Convert matching Linears of a CSM (or a sub-tree) to LoRA/DoRA.

    config: {"rank": int, "scale": float, "dropout": float, "keys": [...],
    "seed": int}. Raises when no leaf was adapted or a target is quantized
    or fused (adapt before `quantize_model` / `fuse_layer_weights`).
    """
    keys = set(config.get("keys") or [])
    if "attn" in keys:
        keys.discard("attn")
        keys.update(DEFAULT_KEYS)
    if not keys:
        keys.update(DEFAULT_KEYS)

    params = model.params if isinstance(model, CSM) else model
    rank = config["rank"]
    scale = config.get("scale", 20.0 / max(rank, 1))
    dropout = config.get("dropout", 0.0)
    counter = [0]
    skipped: List[str] = []
    generator = None
    fused_names = ("self_attn.qkv_proj", "mlp.gateup_proj")
    fused_targets = {"self_attn.q_proj", "self_attn.k_proj",
                     "self_attn.v_proj", "mlp.gate_proj", "mlp.up_proj"}

    def visit(tree, path):
        nonlocal generator
        if isinstance(tree, dict):
            if any(path.endswith(k) for k in keys):
                if "weight" in tree:
                    if generator is None:
                        generator = torch.Generator(
                            device=tree["weight"].device)
                        generator.manual_seed(config.get("seed", 0))
                    counter[0] += 1
                    _adapt_leaf(tree, rank, scale, dropout, use_dora,
                                generator)
                    return
                if "weight_q" in tree:
                    skipped.append(path)  # quantized: no raw weight to adapt
                    return
            if any(path.endswith(f) for f in fused_names) and \
                    keys & fused_targets:
                skipped.append(path)
                return
            for k, v in tree.items():
                visit(v, f"{path}.{k}" if path else k)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                visit(v, f"{path}.{i}")

    visit(params, "")
    if skipped or counter[0] == 0:
        detail = f"; quantized/fused targets: {skipped[:4]}" if skipped else ""
        raise ValueError(
            f"linear_to_lora_layers adapted {counter[0]} leaves and found "
            f"{len(skipped)} unadaptable targets{detail} — convert to LoRA "
            f"BEFORE quantize_model/fuse_layer_weights, or pass keys that "
            f"match the current layout")


def fuse_lora(model: CSM) -> None:
    """Fold adapters into plain weights (inference)."""
    def visit(tree):
        if isinstance(tree, dict):
            if "lora_a" in tree:
                tree["weight"] = effective_weight(tree).detach()
                for k in ("lora_a", "lora_b", "lora_scale", "dora_m",
                          "lora_dropout"):
                    tree.pop(k, None)
                return
            for v in tree.values():
                visit(v)
        elif isinstance(tree, list):
            for v in tree:
                visit(v)

    visit(model.params)


def save_adapter_weights(model: CSM, file_path, weight_filter=None) -> None:
    """Write adapters.safetensors (reference per-layer names);
    `weight_filter` defaults to `trainable_filter`."""
    from csm_mlx_tpu_torch import safetensors_io
    from csm_mlx_tpu_torch.loaders import params_to_reference_flat

    flt = weight_filter or trainable_filter
    flat = params_to_reference_flat(model.params)
    safetensors_io.save_file({k: v for k, v in flat.items() if flt(k)},
                             str(file_path))


def save_adapters(model: CSM, adapter_dir: str, config: Dict,
                  fine_tune_type: str = "lora") -> None:
    """Write adapter_config.json + adapters.safetensors."""
    path = Path(adapter_dir)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "adapter_config.json", "w") as f:
        json.dump({"fine_tune_type": fine_tune_type,
                   "lora_parameters": config}, f, indent=2)
    save_adapter_weights(model, path / "adapters.safetensors")


def load_adapters(model: CSM, adapter_path: str) -> CSM:
    """Re-apply the LoRA structure of adapter_config.json and load the
    adapter weights."""
    path = Path(adapter_path)
    if not path.exists():
        raise FileNotFoundError(f"The adapter path does not exist: {path}")
    with open(path / "adapter_config.json") as fid:
        config = types.SimpleNamespace(**json.load(fid))
    fine_tune_type = getattr(config, "fine_tune_type", "lora")
    if fine_tune_type != "full":
        linear_to_lora_layers(model, config.lora_parameters,
                              use_dora=(fine_tune_type == "dora"))
    model.load_weights(str(path / "adapters.safetensors"), strict=False)
    return model

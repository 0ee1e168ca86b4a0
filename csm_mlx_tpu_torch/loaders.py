"""Safetensors <-> parameter-tree conversion for CSM checkpoints (port of
`csm_mlx_tpu/loaders.py`, local files only).

The reference stores CSM weights as flat dot-separated safetensors, and the
in-memory tree uses the same names and layouts (Linear (out, in),
embeddings (vocab, dim), `audio_head` (31, d, vocab)), so loading is pure
renaming:

  backbone.layers.{i}.self_attn.q_proj.weight -> params["backbone"]["layers"][i]...
  audio_head                                  -> params["audio_head"]

Files are read and written by `safetensors_io` (no `safetensors` package
on the machine with the card). A file written by the JAX package loads
here, and the reverse.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from csm_mlx_tpu_torch import safetensors_io
from csm_mlx_tpu_torch.device import resolve_device


def _load_flat(path: str, device) -> Dict[str, torch.Tensor]:
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path!r}")
    return safetensors_io.load_file(path, device)


def flat_to_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """'a.layers.3.b' flat keys -> nested dicts with real lists for layers."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        cur = tree
        for i, p in enumerate(parts[:-1]):
            nxt = parts[i + 1]
            if p.isdigit():
                p = int(p)
            if isinstance(p, int):
                while len(cur) <= p:
                    cur.append({})
                if not isinstance(cur[p], (dict, list)):
                    cur[p] = {}
                cur = cur[p]
                continue
            if p not in cur:
                cur[p] = [] if nxt.isdigit() else {}
            cur = cur[p]
        last = parts[-1]
        if last.isdigit():
            idx = int(last)
            while len(cur) <= idx:
                cur.append(None)
            cur[idx] = value
        else:
            cur[last] = value
    return tree


def tree_to_flat(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts / lists -> flat dot-separated names. Derived "_"-prefixed
    entries (e.g. kernel 3's "_resident" tables) are skipped: they are
    rebuilt from the weights, never checkpointed."""
    flat: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(k, str) and k.startswith("_"):
                continue
            flat.update(tree_to_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(tree_to_flat(v, f"{prefix}{i}."))
    else:
        flat[prefix[:-1]] = tree
    return flat


def params_to_reference_flat(params: Dict[str, Any]) -> Dict[str, Any]:
    """Params tree -> flat dict with the reference's per-layer names."""
    return tree_to_flat(params)


def _cast_leaf(key: str, v: torch.Tensor, dtype) -> torch.Tensor:
    """Cast a checkpoint tensor to the model dtype — floats only: integer
    codes and the fp32 `scales`/`biases` that calibrate them keep theirs."""
    if not v.is_floating_point():
        return v
    if key.rsplit(".", 1)[-1] in ("scales", "biases"):
        return v
    return v.to(dtype)


def _copy_spine(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _copy_spine(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_spine(v) for v in tree]
    return tree


_FUSED_GROUPS = (("qkv_proj", ("q_proj", "k_proj", "v_proj")),
                 ("gateup_proj", ("gate_proj", "up_proj")))


def _merge(dst: Any, src: Any) -> Any:
    """Merge `src` into `dst` in place. A dense weight evicts a quantized
    sibling and the reverse; a fused checkpoint evicts the unfused parts
    (and refuses adapters on them); an unfused update over a fused model
    must carry every part's base weight (the fused array holds the only
    copy of the others) or it raises."""
    if isinstance(src, dict) and isinstance(dst, dict):
        if "weight" in src and "weight_q" not in src:
            for k in ("weight_q", "scales", "biases"):
                dst.pop(k, None)
        if "weight_q" in src and "weight" not in src:
            dst.pop("weight", None)
        for fused, parts in _FUSED_GROUPS:
            if fused in src:
                adapted = [p for p in parts
                           if isinstance(dst.get(p), dict)
                           and "lora_a" in dst[p]]
                if adapted:
                    raise ValueError(
                        f"checkpoint provides {fused!r} but the model "
                        f"carries LoRA adapters on {adapted}, which the "
                        f"fused forward path would silently ignore. Fuse or "
                        f"strip the adapters before loading this checkpoint.")
                for p in parts:
                    if isinstance(dst.get(p), dict):
                        for k in ("weight", "weight_q", "scales", "biases"):
                            dst[p].pop(k, None)
                        if not dst[p]:
                            dst.pop(p)
                continue
            if fused not in dst:
                continue
            named = [p for p in parts if p in src]
            if not named:
                continue
            full = all(isinstance(src.get(p), dict)
                       and ("weight" in src[p] or "weight_q" in src[p])
                       for p in parts)
            if full:
                dst.pop(fused)
            else:
                raise ValueError(
                    f"checkpoint updates {named} but the model's weights are "
                    f"fused into {fused!r}, which holds the only copy of the "
                    f"other projections; the update cannot take effect. Load "
                    f"the checkpoint before quantize/fuse, or save one "
                    f"carrying base weights for all of {list(parts)}.")
        for k, v in src.items():
            dst[k] = _merge(dst[k], v) if k in dst else v
        return dst
    if isinstance(src, list) and isinstance(dst, list):
        for i, v in enumerate(src):
            if i < len(dst):
                dst[i] = _merge(dst[i], v)
            else:
                dst.append(v)
        return dst
    return src


def load_csm_weights(path: str, dtype=torch.bfloat16, strict: bool = True,
                     existing: Optional[Dict[str, Any]] = None,
                     device: torch.device | str | None = None
                     ) -> Dict[str, Any]:
    """Load a reference-format checkpoint into the CSM parameter tree on
    `device` (default: that of `existing`, else `cuda`).

    With strict=False, keys missing from the file keep the `existing`
    values (trainable-only checkpoints, adapters); the caller's tree is not
    modified (its dict/list spine is copied), and derived "_" entries are
    dropped, since they would serve stale weights.
    """
    device = resolve_device(device, existing)
    flat = _load_flat(path, device)
    # MLX checkpoints may carry rope caches; rope is recomputed here
    flat = {k: v for k, v in flat.items()
            if ".rope." not in k and not k.endswith("._cache")
            and not k.endswith("._theta")}
    tree = flat_to_tree({k: _cast_leaf(k, v, dtype) for k, v in flat.items()})
    if strict:
        required = ("backbone", "decoder", "text_embeddings",
                    "audio_embeddings", "projection", "codebook0_head",
                    "audio_head")
        missing = [k for k in required if k not in tree]
        if missing:
            raise ValueError(f"Checkpoint {path} missing components: {missing}")
        return tree
    merged = _copy_spine(existing or {})
    _merge(merged, tree)
    for k in [k for k in merged if isinstance(k, str) and k.startswith("_")]:
        del merged[k]
    return merged


def save_csm_weights(path: str, params: Dict[str, Any]) -> None:
    """Write the params (reference names) to a safetensors file."""
    safetensors_io.save_file(params_to_reference_flat(params), path)

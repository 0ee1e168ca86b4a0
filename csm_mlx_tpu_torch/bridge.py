"""Carry weights and configurations from the JAX package to the port.

The JAX package keeps parameters as a nested dict / list pytree; fetched
to the host (`jax.device_get`) its leaves are numpy arrays (bf16 ones as
`ml_dtypes.bfloat16`). `tree_to_torch` turns such a tree into the port's
tensors under the same nested names — raw CSM params, CSM params after
`quantize_model(..., fuse=True)` in any mode (W8A8: int8 codes; W4A8:
int4 codes widened to int8; affine: uint8 or packed uint4 codes; fp32
scales and biases, fused qkv/gate-up; the int8 audio head's dict leaf by
leaf) and Mimi params alike — so both sides compute
the same function. A `_resident` entry (the JAX whole-frame decoder's
tables) is carried across in the port's layout by `resident_to_torch`.
Configs (any object with the dataclass fields of `LlamaConfig` /
`MimiConfig`) are copied field by field and can be registered in the
port's registries. This module imports no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from csm_mlx_tpu_torch.config import (BACKBONE_CONFIGURATION,
                                      DECODER_CONFIGURATION, LlamaConfig,
                                      RopeScalingConfig)
from csm_mlx_tpu_torch.models.mimi.config import MimiConfig


def array_to_torch(a: Any, device: torch.device | str = "cpu",
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One numpy leaf -> tensor; bf16 leaves keep their bits. 4-bit affine
    codes (`ml_dtypes` uint4, (OUT, IN)) are packed two to a byte into the
    port's uint8 (OUT, IN/2) layout (`ops.quant.pack_uint4`); uint8 codes,
    also a TPU's 4-bit codes in uint8 carriers, stay 8-bit codes (the same
    dequantized weight). Signed int4 codes (W4A8 on the JAX CPU) are widened
    to the port's int8 carriers, the layout a TPU keeps them in."""
    a = np.asarray(a)
    if a.dtype.name == "int4":
        return torch.from_numpy(a.astype(np.int8)).to(device)
    if a.dtype.name == "uint4":
        from csm_mlx_tpu_torch.ops.quant import pack_uint4

        return pack_uint4(torch.from_numpy(a.astype(np.uint8))).to(device)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


# fp32 scalars of LoRA dicts that keep their type whatever `dtype` says, as
# the JAX package keeps them
_OWN_DTYPE = ("lora_scale", "lora_dropout")


def tree_to_torch(tree: Any, device: torch.device | str = "cpu",
                  dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts / lists of arrays -> the same structure of tensors.
    `dtype` recasts floating leaves (codes, int leaves and the LoRA
    `lora_scale` / `lora_dropout` scalars keep theirs); a `_resident` entry
    goes through `resident_to_torch` as it is. LoRA/DoRA trees (`lora_a`,
    `lora_b`, `lora_scale`, `dora_m`) carry across as they are."""
    if isinstance(tree, dict):
        return {k: resident_to_torch(v, device) if k == "_resident"
                else array_to_torch(v, device) if k in _OWN_DTYPE
                else tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device, dtype) for v in tree]
    return array_to_torch(tree, device, dtype)


def resident_to_torch(res: Any, device: torch.device | str = "cpu"
                      ) -> dict:
    """The JAX `params["_resident"]` (fetched to numpy) -> the port's
    whole-frame decoder tables (see `ops.resident_decoder`): the layers'
    10 tables, "norm" and "rope_cs" as they are; "embed_tab" (N, 1, d) ->
    (N, d); "audio_head_q" (n_cb-1, d, v_pad) -> (n_cb-1, v_pad, d), one
    head column contiguous; "audio_head_s" (n_cb-1, 1, v_pad) ->
    (n_cb-1, v_pad). JAX's rotation matrices ("rot") and bf16 padded head
    ("audio_head") are left behind: the port reads neither."""
    embed = np.asarray(res["embed_tab"])
    head_q = np.asarray(res["audio_head_q"])
    head_s = np.asarray(res["audio_head_s"])
    return {
        "layers": [[array_to_torch(t, device) for t in lw]
                   for lw in res["layers"]],
        "norm": array_to_torch(res["norm"], device),
        "rope_cs": array_to_torch(res["rope_cs"], device),
        "embed_tab": array_to_torch(embed.reshape(embed.shape[0], -1),
                                    device),
        "audio_head_q": array_to_torch(
            np.ascontiguousarray(head_q.transpose(0, 2, 1)), device),
        "audio_head_s": array_to_torch(
            head_s.reshape(head_s.shape[0], -1), device),
    }


def llama_config_from(cfg: Any) -> LlamaConfig:
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(LlamaConfig)}
    rs = fields["rope_scaling"]
    if rs is not None:
        fields["rope_scaling"] = RopeScalingConfig(**{
            f.name: getattr(rs, f.name)
            for f in dataclasses.fields(RopeScalingConfig)})
    return LlamaConfig(**fields)


def mimi_config_from(cfg: Any) -> MimiConfig:
    return MimiConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(MimiConfig)})


def register_llama_configs(backbone: dict | None = None,
                           decoder: dict | None = None) -> None:
    """Register configs (name -> config object of either package) in the
    port's BACKBONE_CONFIGURATION / DECODER_CONFIGURATION."""
    for name, cfg in (backbone or {}).items():
        BACKBONE_CONFIGURATION[name] = llama_config_from(cfg)
    for name, cfg in (decoder or {}).items():
        DECODER_CONFIGURATION[name] = llama_config_from(cfg)

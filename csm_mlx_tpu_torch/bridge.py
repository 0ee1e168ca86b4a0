"""Carry weights and configurations from the JAX package to the port.

The JAX package keeps parameters as a nested dict / list pytree; fetched
to the host (`jax.device_get`) its leaves are numpy arrays (bf16 ones as
`ml_dtypes.bfloat16`). `tree_to_torch` turns such a tree into the port's
tensors under the same nested names — raw CSM params, CSM params after
`quantize_model(mode="w8a8", fuse=True)` (int8 codes, fp32 scales and
biases, fused qkv/gate-up) and Mimi params alike — so both sides compute
the same function. Configs (any object with the dataclass fields of
`LlamaConfig` / `MimiConfig`) are copied field by field and can be
registered in the port's registries. This module imports no JAX.
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
    """One numpy leaf -> tensor; bf16 leaves keep their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def tree_to_torch(tree: Any, device: torch.device | str = "cpu",
                  dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts / lists of arrays -> the same structure of tensors.
    `dtype` recasts floating leaves (codes and int leaves keep theirs)."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device, dtype) for v in tree]
    return array_to_torch(tree, device, dtype)


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

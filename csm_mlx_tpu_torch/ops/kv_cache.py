"""Static-capacity KV cache (port of `csm_mlx_tpu/ops/kv_cache.py::KVCache`).

Layout as in the JAX package: k, v (num_layers, B, n_kv, capacity,
head_dim). Unlike the JAX cache (immutable, returned anew by every call),
this one is UPDATED IN PLACE: `update_layer` writes into the buffers and
`advance` moves the shared write index, a Python int. Both still return the
cache so call sites read like the JAX ones.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from csm_mlx_tpu_torch.config import LlamaConfig


@dataclasses.dataclass
class KVCache:
    """Per-layer stack of keys/values with a shared write index.

    k, v: (num_layers, B, n_kv_heads, capacity, head_dim)
    index: number of tokens already written (= next write slot).
    """

    k: torch.Tensor
    v: torch.Tensor
    index: int = 0

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @staticmethod
    def init(cfg: LlamaConfig, batch_size: int, capacity: int,
             dtype=torch.bfloat16, device: torch.device | str = "cpu"
             ) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch_size, cfg.num_key_value_heads,
                 capacity, cfg.head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))

    def update_layer(self, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor
                     ) -> Tuple["KVCache", torch.Tensor, torch.Tensor]:
        """Write S new tokens (B, n_kv, S, D) of `layer` at `index`, in
        place; return (self, k[layer], v[layer]) over the whole capacity.

        Unlike the JAX `dynamic_update_slice`, which clamps an out-of-range
        start and silently overwrites the newest slots, an overflowing write
        raises."""
        s = k_new.shape[2]
        if self.index + s > self.capacity:
            raise ValueError(f"KV cache overflow: index {self.index} + {s} "
                             f"new tokens > capacity {self.capacity}")
        self.k[layer, :, :, self.index:self.index + s] = k_new.to(self.k.dtype)
        self.v[layer, :, :, self.index:self.index + s] = v_new.to(self.v.dtype)
        return self, self.k[layer], self.v[layer]

    def advance(self, n_tokens: int) -> "KVCache":
        self.index += int(n_tokens)
        return self

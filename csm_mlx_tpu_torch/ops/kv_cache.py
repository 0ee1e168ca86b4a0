"""Static-capacity KV cache (port of `csm_mlx_tpu/ops/kv_cache.py::KVCache`).

Layout as in the JAX package: k, v (num_layers, B, n_kv, capacity,
head_dim), and the write index a () int32 tensor on the cache's device.
Unlike the JAX cache (immutable, returned anew by every call), this one is
UPDATED IN PLACE: `update_layer` writes into the buffers at
`index + arange(S)` and `advance` adds to the index tensor. So a step
captured in a CUDA graph reads and moves the index on the device at every
replay, where a Python int would be baked into the graph. `length` is the
host's count of the same tokens: the overflow check reads it, never the
device index. A caller that moves the index outside Python (a graph
replay) keeps `length` in step itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from csm_mlx_tpu_torch.config import LlamaConfig
from csm_mlx_tpu_torch.device import resolve_device


@dataclasses.dataclass
class KVCache:
    """Per-layer stack of keys/values with a shared write index.

    k, v: (num_layers, B, n_kv_heads, capacity, head_dim)
    index: () int32 on k's device, tokens already written (= next write
      slot); an int is taken too, and a given tensor is copied, so two
      caches never share one index.
    length: the host's count of the written tokens; by default the
      index's value (a tensor index is read back once for it).
    """

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor | int = 0
    length: Optional[int] = None
    _slots: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                       repr=False)

    def __post_init__(self):
        if self.length is None:
            self.length = int(self.index)
        self.index = torch.as_tensor(self.index).to(
            device=self.k.device, dtype=torch.int32).clone().reshape(())

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @staticmethod
    def init(cfg: LlamaConfig, batch_size: int, capacity: int,
             dtype=torch.bfloat16, device: torch.device | str | None = None
             ) -> "KVCache":
        """Zeroed buffers on `device` (default `cuda`), for the kv heads
        this rank holds under a sharded model's tensor parallelism
        (`ops.tensor_parallel.local_kv_heads`; all of them without)."""
        from csm_mlx_tpu_torch.ops.tensor_parallel import local_kv_heads

        device = resolve_device(device)
        shape = (cfg.num_hidden_layers, batch_size, local_kv_heads(cfg),
                 capacity, cfg.head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       index=torch.zeros((), dtype=torch.int32, device=device),
                       length=0)

    def update_layer(self, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor
                     ) -> Tuple["KVCache", torch.Tensor, torch.Tensor]:
        """Write S new tokens (B, n_kv, S, D) of `layer` at `index`, in
        place; return (self, k[layer], v[layer]) over the whole capacity.

        Unlike the JAX `dynamic_update_slice`, which clamps an out-of-range
        start and silently overwrites the newest slots, an overflowing write
        raises (checked on the host's `length`)."""
        s = k_new.shape[2]
        if self.length + s > self.capacity:
            raise ValueError(f"KV cache overflow: index {self.length} + {s} "
                             f"new tokens > capacity {self.capacity}")
        if self._slots is None or self._slots.shape[0] != s:
            # the S slots of this forward, shared by its layers
            self._slots = self.index.long() + torch.arange(
                s, device=self.k.device)
        self.k[layer].index_copy_(2, self._slots, k_new.to(self.k.dtype))
        self.v[layer].index_copy_(2, self._slots, v_new.to(self.v.dtype))
        return self, self.k[layer], self.v[layer]

    def advance(self, n_tokens: int) -> "KVCache":
        self.index.add_(int(n_tokens))
        self.length += int(n_tokens)
        self._slots = None
        return self

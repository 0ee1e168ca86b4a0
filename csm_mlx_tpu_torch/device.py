"""Where the port runs: on the card unless the caller asks for the CPU.

Entry points that make tensors (`CSM`, `Mimi`, the `init_*` helpers,
`KVCache.init`, `rope_cache_for`) take `device=None`. Given parameters,
they run where the parameters are; otherwise on `cuda`. Without a visible
GPU that raises: the CPU is never taken quietly, it has to be asked for
with `device="cpu"`.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


def first_tensor(tree: Any) -> Optional[torch.Tensor]:
    """The first tensor leaf of nested dicts / lists, or None."""
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in values:
        t = first_tensor(v)
        if t is not None:
            return t
    return None


def resolve_device(device: torch.device | str | None = None,
                   params: Any = None) -> torch.device:
    """`device` if given; else the device of `params`' tensors; else
    `cuda`, which raises a RuntimeError when no GPU is visible."""
    if device is not None:
        return torch.device(device)
    leaf = first_tensor(params)
    if leaf is not None:
        return leaf.device
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is visible; pass device="cpu" '
                           'to run on the CPU')
    return torch.device("cuda", torch.cuda.current_device())

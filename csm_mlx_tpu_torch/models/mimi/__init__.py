"""The Mimi audio codec."""

from csm_mlx_tpu_torch.models.mimi.config import MimiConfig, mimi_202407
from csm_mlx_tpu_torch.models.mimi.mimi import (Mimi, init_mimi_params,
                                                mimi_decode_fn, mimi_encode_fn)

__all__ = ["Mimi", "MimiConfig", "init_mimi_params", "mimi_202407",
           "mimi_decode_fn", "mimi_encode_fn"]

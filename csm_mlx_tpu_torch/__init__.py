"""csm_mlx_tpu_torch — the PyTorch / CUDA (H100) port of `csm_mlx_tpu`.

The JAX package stays the reference; this package mirrors its module
layout and function names. Importing it loads only torch and numpy: the
hand-written CUDA kernels under `csrc/` are compiled with `nvcc` at their
first launch (`csm_mlx_tpu_torch.ops._build`), never at import.

Main path: `models.csm.CSM` -> `ops.quant.quantize_model` (mode="w8a8",
or the default MLX-affine 4-bit group 64) -> `generation.generate_tokens`
(or `generate_tokens_batch`, with `flash_decode_min_b` for the
flash-decode kernel) -> `models.mimi.Mimi.decode`.
"""

"""csm_mlx_tpu_torch — the PyTorch / CUDA (H100) port of `csm_mlx_tpu`.

The JAX package stays the reference; this package mirrors its module
layout and function names. Importing it loads only torch and numpy: the
hand-written CUDA kernels under `csrc/` are compiled with `nvcc` at their
first launch (`csm_mlx_tpu_torch.ops._build`), never at import.

Main path: `models.csm.CSM` -> `ops.quant.quantize_model(mode="w8a8")` ->
`generation.generate_tokens` -> `models.mimi.Mimi.decode`.
"""

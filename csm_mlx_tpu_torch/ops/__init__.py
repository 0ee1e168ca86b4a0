"""Tensor ops of the port: rope, layers, attention, KV cache, quantization,
sampling, and the build of the CUDA kernels."""

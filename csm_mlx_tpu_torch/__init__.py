"""csm_mlx_tpu_torch — the PyTorch / CUDA (H100) port of `csm_mlx_tpu`.

The JAX package stays the reference; this package mirrors its module
layout, its function names and its public surface (`__all__`). Importing
it loads torch and numpy and the inference modules; the fine-tuning stack,
the servers and the continuous engine load at their first use
(`__getattr__`). The hand-written CUDA kernels under `csrc/` are compiled
with `nvcc` at their first launch (`csm_mlx_tpu_torch.ops._build`), never
at import.

    from csm_mlx_tpu_torch import CSM, csm_1b, generate, quantize

Entry points run on `cuda` unless given CPU params or `device="cpu"`
(`device.resolve_device`). Main path: `CSM` -> `quantize` (mode="w8a8" or
"w4a8", or the default MLX-affine 4-bit group 64) -> `generate` (or
`generate_tokens` / `generate_tokens_batch`) -> Mimi decode. The command
line is `python -m csm_mlx_tpu_torch` (`csm-torch`): `generate`, `serve`
and `finetune`.
"""

from csm_mlx_tpu_torch.config import (
    BACKBONE_CONFIGURATION,
    DECODER_CONFIGURATION,
    TOKENIZERS,
    LlamaConfig,
)
from csm_mlx_tpu_torch.models.csm import CSM, ModelArgs, csm_1b
from csm_mlx_tpu_torch.generation import (
    generate,
    generate_batch,
    generate_frame,
    generate_long,
    stream_generate,
)
from csm_mlx_tpu_torch.ops.quant import quantize_model as quantize
from csm_mlx_tpu_torch.ops.sampling import make_logits_processors, make_sampler
from csm_mlx_tpu_torch.segment import Segment
from csm_mlx_tpu_torch.watermark import detect_watermark, embed_watermark

__all__ = [
    "CSM",
    "ModelArgs",
    "csm_1b",
    "generate",
    "generate_batch",
    "generate_frame",
    "generate_long",
    "stream_generate",
    "quantize",
    "Segment",
    "make_sampler",
    "make_logits_processors",
    "embed_watermark",
    "detect_watermark",
    "LlamaConfig",
    "BACKBONE_CONFIGURATION",
    "DECODER_CONFIGURATION",
    "TOKENIZERS",
    "CSMDataset",
    "CSMTrainer",
    "TrainArgs",
    "load_adapters",
    "TTSServer",
    "ContinuousTTSServer",
    "ContinuousEngine",
]

__version__ = "0.5.0"


def __getattr__(name):
    # Lazy, as in the JAX package: inference-only users do not load the
    # trainers, the servers or the engine.
    if name in ("CSMDataset", "CSMPairwiseDataset", "CSMPointwiseDataset"):
        from csm_mlx_tpu_torch.finetune import dataset as _ds

        return getattr(_ds, name)
    if name in ("CSMTrainer", "DPOTrainer", "KTOTrainer", "TrainArgs",
                "DPOArgs", "KTOArgs"):
        from csm_mlx_tpu_torch.finetune import trainer as _tr

        return getattr(_tr, name)
    if name == "load_adapters":
        from csm_mlx_tpu_torch.finetune.lora import load_adapters

        return load_adapters
    if name in ("TTSServer", "ContinuousTTSServer"):
        from csm_mlx_tpu_torch import serve as _srv

        return getattr(_srv, name)
    if name == "ContinuousEngine":
        from csm_mlx_tpu_torch.continuous import ContinuousEngine

        return ContinuousEngine
    raise AttributeError(
        f"module 'csm_mlx_tpu_torch' has no attribute {name!r}")

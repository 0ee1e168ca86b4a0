"""The system under test, built from a configuration file and a seed: the
port's CSM and Mimi over the benchmark's seeded weights, quantized and
prepared as the port does on load. Nothing else of the port is touched
here."""

from __future__ import annotations

import dataclasses

import torch

from gpubench import arch, weights
from gpubench.arch import llama


def model_args(config: dict):
    """The port's ModelArgs of a configuration, its two stacks registered
    under the configuration's name: the backbone's as its architecture's
    file makes it (`arch`), the decoder's as a Llama stack."""
    from csm_mlx_tpu_torch.config import (BACKBONE_CONFIGURATION,
                                          DECODER_CONFIGURATION)
    from csm_mlx_tpu_torch.models.csm import ModelArgs

    name = config["name"]
    BACKBONE_CONFIGURATION[f"{name}.backbone"] = arch.load(
        config).port_config(config["backbone"])
    DECODER_CONFIGURATION[f"{name}.decoder"] = llama.port_config(
        config["decoder"])
    return ModelArgs(backbone_name=f"{name}.backbone",
                     decoder_name=f"{name}.decoder",
                     n_text_vocab=config["text_vocab_size"],
                     n_audio_vocab=config["audio_vocab_size"],
                     n_audio_codebooks=config["audio_num_codebooks"])


def build_csm(config: dict, seed: int, device: torch.device):
    """CSM over the seeded weights in the configuration's dtype, quantized
    as it states (on the card `quantize_model` also derives kernel 3's
    tables; on the CPU they are derived here, so that the plain kernel
    runs as the card's would)."""
    from csm_mlx_tpu_torch.models.csm import CSM
    from csm_mlx_tpu_torch.ops import quant

    dtype = getattr(torch, config.get("dtype", "bfloat16"))
    model = CSM(model_args(config),
                params=weights.csm_params(config, seed, device, dtype),
                dtype=dtype, device=device)
    q = config.get("quantization")
    if q:
        quant.quantize_model(model, mode=q["mode"], fuse=q.get("fuse", True),
                             targets=tuple(q["targets"]))
        if device.type != "cuda":
            from csm_mlx_tpu_torch.ops.resident_decoder import \
                prepare_resident_decoder

            prepare_resident_decoder(model)
    return model


def mimi_config(config: dict):
    from csm_mlx_tpu_torch.models.mimi import MimiConfig

    fields = {f.name for f in dataclasses.fields(MimiConfig)}
    m = {k: (tuple(v) if isinstance(v, list) else v)
         for k, v in config["mimi"].items() if k in fields}
    return MimiConfig(**m)


def build_mimi(config: dict, seed: int, device: torch.device,
               encoder: bool = False):
    from csm_mlx_tpu_torch.models.mimi import Mimi

    return Mimi(mimi_config(config), params=weights.mimi_params(
        config, seed, device, encoder), dtype=torch.float32, device=device)

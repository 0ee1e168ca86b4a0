"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same parameters and inputs go through the JAX package and the port:
JAX params are fetched to numpy and converted by `csm_mlx_tpu_torch.bridge`.
"""

import jax
import numpy as np
import torch

from conftest import TINY_BACKBONE, TINY_DECODER
from csm_mlx_tpu_torch import bridge
from csm_mlx_tpu_torch.models.csm import CSM as TorchCSM
from csm_mlx_tpu_torch.models.csm import ModelArgs as TorchModelArgs

# Tier-1 runs several pytest workers: keep each to one intra-op thread.
torch.set_num_threads(1)
bridge.register_llama_configs(backbone={"tiny": TINY_BACKBONE},
                              decoder={"tiny": TINY_DECODER})


def to_torch(tree, dtype=None):
    return bridge.tree_to_torch(jax.device_get(tree), dtype=dtype)


def to_jax(tree):
    """A tree of the port's tensors -> the same tree of JAX arrays (through
    numpy): the port's random init is fast where JAX's compiles an op per
    shape."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_jax(v) for v in tree]
    return jax.numpy.asarray(tree.detach().cpu().numpy())


def torch_model_from_jax(model, dtype=torch.float32) -> TorchCSM:
    a = model.args
    args = TorchModelArgs(a.backbone_name, a.decoder_name, a.n_text_vocab,
                          a.n_audio_vocab, a.n_audio_codebooks)
    return TorchCSM(args, params=to_torch(model.params), dtype=dtype)


def text_prompt(args, s, seed=0):
    rng = np.random.RandomState(seed)
    k = args.n_audio_codebooks + 1
    prompt = np.zeros((s, k), dtype=np.int32)
    prompt[:, -1] = rng.randint(0, args.n_text_vocab, size=s)
    mask = np.zeros((s, k), dtype=np.int32)
    mask[:, -1] = 1
    return prompt, mask

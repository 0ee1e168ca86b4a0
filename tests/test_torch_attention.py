"""PyTorch port vs JAX package: kernel 2 (flash prefill). On the CPU the
port's wrapper runs its plain version; the JAX Pallas kernel runs in
interpret mode, as its own tests run it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_torch
from csm_mlx_tpu.config import LlamaConfig as JLlamaConfig
from csm_mlx_tpu.models.llama import init_llama_params, llama_forward as jfwd
from csm_mlx_tpu.ops.attention import flash_prefill_sdpa as jflash
from csm_mlx_tpu.ops.kv_cache import KVCache as JKVCache
from csm_mlx_tpu.ops.rope import rope_cache_for as jrope_cache
from csm_mlx_tpu_torch.bridge import llama_config_from
from csm_mlx_tpu_torch.models.llama import llama_forward as tfwd
from csm_mlx_tpu_torch.ops import attention as tattn
from csm_mlx_tpu_torch.ops.kv_cache import KVCache as TKVCache
from csm_mlx_tpu_torch.ops.rope import rope_cache_for as trope_cache

ATOL = 2e-5  # fp32: the two softmaxes differ only in reduction order


def _qkv(seed, b, h, kv, s, d):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, s, d) * 0.3).astype(np.float32)
    k = (rng.randn(b, kv, s, d) * 0.3).astype(np.float32)
    v = rng.randn(b, kv, s, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("s", [128, 256])
def test_flash_prefill_plain_matches_jax_interpret(s):
    b, h, kv, d = 3, 4, 2, 16
    pads = np.array([0, 5, 100], np.int32)
    q, k, v = _qkv(s, b, h, kv, s, d)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             d ** -0.5, jnp.asarray(pads)))
    got = tattn.flash_prefill_sdpa(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), d ** -0.5,
                                   torch.from_numpy(pads)).numpy()
    assert np.isfinite(got).all()
    for bi, p0 in enumerate(pads):  # rows before the pad see no key
        np.testing.assert_allclose(got[bi, :, p0:], want[bi, :, p0:],
                                   atol=ATOL, rtol=0)


def test_llama_flash_prefill_path_matches_jax():
    """llama_forward with flash_pad_len (over k/v slices of a cache)
    against the JAX flash path: hidden rows past the pad and the cache."""
    jcfg = JLlamaConfig(num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=16,
                        intermediate_size=64, hidden_size=64,
                        max_position_embeddings=256)
    params = init_llama_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    b, s, cap = 2, 128, 160
    rng = np.random.RandomState(2)
    x = (rng.randn(b, s, 64) * 0.3).astype(np.float32)
    pad = np.array([0, 37], np.int32)
    pos = np.arange(s)[None, :] - pad[:, None]
    jc, js = jrope_cache(jcfg, 256)
    want, jcache = jfwd(params, jcfg, jnp.asarray(x), jc, js,
                        jnp.asarray(pos), None,
                        JKVCache.init(jcfg, b, cap, dtype=jnp.float32),
                        flash_pad_len=jnp.asarray(pad))
    tcfg = llama_config_from(jcfg)
    tc, ts = trope_cache(tcfg, 256)
    got, tcache = tfwd(to_torch(params), tcfg, torch.from_numpy(x), tc, ts,
                       torch.from_numpy(pos), None,
                       TKVCache.init(tcfg, b, cap, dtype=torch.float32),
                       flash_pad_len=torch.from_numpy(pad))
    got, want = got.numpy(), np.asarray(want)
    assert tcache.index == s == int(jcache.index)
    for bi, p0 in enumerate(pad):
        np.testing.assert_allclose(got[bi, p0:], want[bi, p0:], atol=3e-5,
                                   rtol=0)
        np.testing.assert_allclose(tcache.k[:, bi, :, p0:s].numpy(),
                                   np.asarray(jcache.k)[:, bi, :, p0:s],
                                   atol=3e-5, rtol=0)

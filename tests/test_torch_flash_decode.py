"""PyTorch port vs JAX package: kernel 4 (flash-decode attention) and the
batched generation path that runs it. On the CPU the port's wrapper runs
its plain version; the JAX Pallas kernel runs in interpret mode
(`CSM_TPU_FLASH_DECODE=interpret`), as the JAX package's own tests run
it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_args
from torch_helpers import text_prompt, torch_model_from_jax
from csm_mlx_tpu import generation as jgen
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu.ops.attention import flash_decode_sdpa as jflash_decode
from csm_mlx_tpu.ops.kv_cache import KVCache as JKVCache
from csm_mlx_tpu.ops.rope import rope_cache_for as jrope_cache
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch.models import llama as tllama
from csm_mlx_tpu_torch.ops import attention as tattn
from csm_mlx_tpu_torch.ops.kv_cache import KVCache as TKVCache
from csm_mlx_tpu_torch.ops.rope import rope_cache_for as trope_cache


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


# the JAX tests' cases (tests/test_flash_attention.py) and their tolerances
@pytest.mark.parametrize("b,heads,kvh,cap,d,index,dtype", [
    (8, 8, 2, 128, 32, 64, "float32"),     # GQA group 4
    (3, 4, 4, 96, 16, 95, "float32"),      # MHA, index at the last slot
    (2, 8, 1, 256, 64, 0, "float32"),      # single kv head, first step
    (4, 8, 2, 128, 64, 80, "bfloat16"),
])
def test_flash_decode_plain_matches_jax_kernel(b, heads, kvh, cap, d, index,
                                               dtype):
    rng = np.random.RandomState(index + cap)
    q = rng.randn(b, heads, 1, d).astype(np.float32) * 0.3
    k = rng.randn(b, kvh, cap, d).astype(np.float32) * 0.3
    v = rng.randn(b, kvh, cap, d).astype(np.float32)
    pad = rng.randint(0, index + 1, (b,)).astype(np.int32)
    jd = jnp.dtype(dtype)
    want = np.asarray(jflash_decode(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), d ** -0.5,
        jnp.asarray(pad), jnp.asarray(index, jnp.int32)), np.float32)
    if dtype == "float32":
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        tol = 2e-5
    else:  # the JAX package's bf16 test: the same bf16 inputs on both sides
        tq, tk, tv = (_bf16(jnp.asarray(a, jd)) for a in (q, k, v))
        tol = 2e-2
    got = tattn.flash_decode_sdpa(tq, tk, tv, d ** -0.5,
                                  torch.from_numpy(pad),
                                  torch.tensor(index, dtype=torch.int32))
    assert got.shape == (b, heads, 1, d) and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_flash_decode_plain_is_the_masked_sdpa():
    """pad <= pos <= index, a row with no valid key included (pad > index):
    the masked softmax averages all of its V rows."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((3, 4, 1, 8), (3, 2, 20, 8), (3, 2, 20, 8)))
    pad = torch.tensor([0, 5, 12])
    got = tattn.flash_decode_plain(q, k, v, 0.3, pad,
                                   torch.tensor(9, dtype=torch.int32))
    for row, p in enumerate((0, 5)):
        kr, vr = k[row, :, p:10], v[row, :, p:10]
        logits = torch.einsum("hgd,hkd->hgk", q[row, :, 0].reshape(2, 2, 8),
                              kr) * 0.3
        want = torch.einsum("hgk,hkd->hgd", logits.softmax(-1), vr)
        torch.testing.assert_close(got[row, :, 0], want.reshape(4, 8))
    want_avg = v[2].mean(dim=1).repeat_interleave(2, dim=0)
    torch.testing.assert_close(got[2, :, 0], want_avg)


@pytest.mark.parametrize("b,n_kv", [(1, 8), (8, 8), (32, 8), (33, 8),
                                    (64, 8), (3, 2)])
def test_flash_decode_split_covers_the_cache(b, n_kv):
    """Kernel 4's split of a cache: chunks of a multiple of 64 keys that
    cover the `cap` slots with no empty chunk, one split from 264 (row, kv
    head) blocks up, else enough splits for ~528 blocks where the cache
    has the keys for them; a function of the shape only."""
    for cap in (1, 40, 64, 65, 157, 1000, 1024, 2048, 2173):
        splits, chunk = tattn.decode_splits(b, n_kv, cap)
        assert chunk % 64 == 0 and splits >= 1
        assert (splits - 1) * chunk < cap <= splits * chunk
        if b * n_kv >= tattn.DECODE_ONE_SPLIT_BLOCKS:
            assert splits == 1
        else:
            want = -(-tattn.DECODE_TARGET_BLOCKS // (b * n_kv))
            assert splits <= min(want, -(-cap // 64))
            assert splits * chunk < cap + 64 * splits  # chunks even to 64
    assert tattn.decode_splits(8, 8, 2048) == (8, 256)
    assert tattn.decode_splits(64, 8, 157) == (1, 192)


@pytest.fixture(scope="module")
def jax_model():
    """A tiny JAX CSM (fp32) with a random audio_head: a zero head would
    make every decoder codebook 0."""
    m = jcsm.CSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(31))
    m.params["audio_head"] = jax.random.normal(
        jax.random.PRNGKey(32), m.params["audio_head"].shape) * 0.5
    return m


def test_backbone_step_flash_decode_matches_jax(jax_model, monkeypatch):
    """One backbone step at B=8 on a filled cache (index 40, per-row pads)
    with kernel 4 on both sides: the port's `flash_decode_min_b=8`, JAX's
    `CSM_TPU_FLASH_DECODE=interpret`. Hidden states within 1e-5; the port's
    step with and without the kernel agrees too."""
    args, bcfg = jax_model.args, jax_model.args.backbone_config
    cap, b, index = 96, 8, 40
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, 60, (b, 1, args.n_audio_codebooks + 1))
    mask = np.ones_like(tokens)
    pad = rng.randint(0, 30, (b,)).astype(np.int32)
    kv = [rng.randn(bcfg.num_hidden_layers, b, bcfg.num_key_value_heads, cap,
                    bcfg.head_dim).astype(np.float32) for _ in range(2)]

    monkeypatch.setenv("CSM_TPU_FLASH_DECODE", "interpret")
    cos, sin = jrope_cache(bcfg, max(cap, bcfg.max_position_embeddings))
    jc = dataclasses.replace(JKVCache.init(bcfg, b, cap, dtype=jnp.float32),
                             k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]),
                             index=jnp.asarray(index, jnp.int32))
    want, _ = jgen._backbone_step(jax_model.params, args,
                                  jnp.asarray(tokens, jnp.int32),
                                  jnp.asarray(mask, jnp.int32),
                                  jnp.asarray(pad), jc, cos, sin)
    want = np.asarray(want)

    tm = torch_model_from_jax(jax_model)
    cos, sin = trope_cache(bcfg, max(cap, bcfg.max_position_embeddings), "cpu")
    calls = []
    monkeypatch.setattr(tllama, "flash_decode_sdpa", lambda *a: (
        calls.append(a[0].shape), tattn.flash_decode_sdpa(*a))[1])

    def step(min_b):
        tc = TKVCache(k=torch.from_numpy(kv[0].copy()),
                      v=torch.from_numpy(kv[1].copy()), index=index)
        h, tc = tgen._backbone_step(tm.params, tm.args,
                                    torch.from_numpy(tokens),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(pad).long(), tc, cos,
                                    sin, flash_decode_min_b=min_b)
        assert tc.index == index + 1
        return h.numpy()

    got = step(8)
    assert len(calls) == bcfg.num_hidden_layers  # one call a layer
    off = step(None)
    assert len(calls) == bcfg.num_hidden_layers
    step(9)  # B = 8 < 9: the gate stays shut
    assert len(calls) == bcfg.num_hidden_layers
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, off, rtol=1e-5, atol=1e-5)


def test_batch_flash_decode_frames_equal_jax(jax_model, monkeypatch):
    """Greedy fp32 `generate_tokens_batch` at B=8 (8 prompts of their own
    lengths, so each row has its own pad) with kernel 4 in every backbone
    step on both sides: frames equal token for token. 6 frames keep the
    JAX loop on its per-frame cache (its tiered block decode, which would
    bypass the kernel, starts at 8)."""
    args = jax_model.args
    prompts, masks = zip(*[text_prompt(args, 5 + 3 * i, seed=40 + i)
                           for i in range(8)])
    monkeypatch.setenv("CSM_TPU_FLASH_DECODE", "interpret")
    # the compiled loop's cache key does not hold this variable
    jgen._build_generate_tokens.cache_clear()
    try:
        want, n_want = jgen.generate_tokens_batch(jax_model, prompts, masks, 6,
                                                  temperature=0.0)
    finally:
        jgen._build_generate_tokens.cache_clear()
    tm = torch_model_from_jax(jax_model)
    calls = []
    monkeypatch.setattr(tllama, "flash_decode_sdpa", lambda *a: (
        calls.append(a[0].shape[0]), tattn.flash_decode_sdpa(*a))[1])
    got, n_got = tgen.generate_tokens_batch(tm, prompts, masks, 6,
                                            temperature=0.0,
                                            flash_decode_min_b=8)
    n_layers = args.backbone_config.num_hidden_layers
    assert calls and set(calls) == {8} and len(calls) % n_layers == 0
    np.testing.assert_array_equal(n_got, n_want)
    np.testing.assert_array_equal(got, want)


def test_single_stream_flash_decode_frames_equal_jax(jax_model, monkeypatch):
    """Greedy fp32 `generate_tokens` (one row) with kernel 4 in every
    backbone step on both sides: the port's `flash_decode_min_b=1`, JAX's
    `CSM_TPU_FLASH_DECODE=interpret` with `CSM_TPU_FLASH_DECODE_MIN_B=1`
    (one row keeps JAX's per-frame loop). Frames equal token for token."""
    args = jax_model.args
    prompt, mask = text_prompt(args, 9, seed=60)
    monkeypatch.setenv("CSM_TPU_FLASH_DECODE", "interpret")
    monkeypatch.setenv("CSM_TPU_FLASH_DECODE_MIN_B", "1")
    jgen._build_generate_tokens.cache_clear()
    try:
        want, n_want = jgen.generate_tokens(jax_model, prompt, mask, 6,
                                            temperature=0.0)
    finally:
        jgen._build_generate_tokens.cache_clear()
    tm = torch_model_from_jax(jax_model)
    calls = []
    monkeypatch.setattr(tllama, "flash_decode_sdpa", lambda *a: (
        calls.append(a[0].shape[0]), tattn.flash_decode_sdpa(*a))[1])
    got, n_got = tgen.generate_tokens(tm, prompt, mask, 6, temperature=0.0,
                                      flash_decode_min_b=1)
    n_layers = args.backbone_config.num_hidden_layers
    assert calls and set(calls) == {1} and len(calls) % n_layers == 0
    assert n_got == n_want
    np.testing.assert_array_equal(got, want)

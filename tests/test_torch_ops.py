"""PyTorch port vs JAX package: rope, rms_norm, swiglu, sdpa + masks,
KVCache, and the no-JAX import rule of the port."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY_BACKBONE
from torch_helpers import to_torch
from csm_mlx_tpu.ops import attention as jattn
from csm_mlx_tpu.ops import layers as jlayers
from csm_mlx_tpu.ops import rope as jrope
from csm_mlx_tpu.ops.kv_cache import KVCache as JKVCache
from csm_mlx_tpu_torch.config import RopeScalingConfig
from csm_mlx_tpu_torch.ops import attention as tattn
from csm_mlx_tpu_torch.ops import layers as tlayers
from csm_mlx_tpu_torch.ops import rope as trope
from csm_mlx_tpu_torch.ops.kv_cache import KVCache as TKVCache
from csm_mlx_tpu_torch.bridge import llama_config_from

ATOL = 1e-5  # fp32 on both sides; only reduction order differs


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def test_rope_freqs_and_rotation_match_jax():
    np.testing.assert_array_equal(
        trope.llama3_scaled_freqs(64, 500_000.0, RopeScalingConfig()),
        jrope.llama3_scaled_freqs(64, 500_000.0,
                                  jrope.RopeScalingConfig()))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 4, 16).astype(np.float32)
    pos = np.array([np.arange(7) - 3, np.arange(7)], np.int32)  # negatives clamp
    jc, js = jrope.rope_cache_for(TINY_BACKBONE, 32)
    tc, ts = trope.rope_cache_for(llama_config_from(TINY_BACKBONE), 32,
                                  "cpu")
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js,
                                       jnp.asarray(pos)))
    got = trope.apply_rope(_t(x), tc, ts, _t(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_rms_norm_and_swiglu_match_jax(fused):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 32).astype(np.float32)
    w = {"weight": rng.randn(32).astype(np.float32)}
    np.testing.assert_allclose(
        tlayers.rms_norm(to_torch(w), _t(x), 1e-5).numpy(),
        np.asarray(jlayers.rms_norm({"weight": jnp.asarray(w["weight"])},
                                    jnp.asarray(x), 1e-5)),
        atol=ATOL, rtol=0)
    g, u, d = (rng.randn(*s).astype(np.float32) * 0.2
               for s in ((48, 32), (48, 32), (32, 48)))
    if fused:
        mlp = {"gateup_proj": {"weight": np.concatenate([g, u])},
               "down_proj": {"weight": d}}
    else:
        mlp = {"gate_proj": {"weight": g}, "up_proj": {"weight": u},
               "down_proj": {"weight": d}}
    jmlp = {k: {"weight": jnp.asarray(v["weight"])} for k, v in mlp.items()}
    np.testing.assert_allclose(
        tlayers.swiglu_mlp(to_torch(mlp), _t(x)).numpy(),
        np.asarray(jlayers.swiglu_mlp(jmlp, jnp.asarray(x))),
        atol=ATOL, rtol=0)


def test_masks_and_sdpa_match_jax():
    rng = np.random.RandomState(2)
    b, h, kv, s, cap, d = 2, 4, 2, 5, 12, 16
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, kv, cap, d).astype(np.float32)
    v = rng.randn(b, kv, cap, d).astype(np.float32)
    np.testing.assert_array_equal(
        tattn.causal_mask_bias(s, cap, q_offset=3).numpy(),
        np.asarray(jattn.causal_mask_bias(s, cap, q_offset=3)))
    valid = np.arange(cap)[None] >= np.array([[0], [4]])
    np.testing.assert_array_equal(
        tattn.key_validity_bias(_t(valid)).numpy(),
        np.asarray(jattn.key_validity_bias(jnp.asarray(valid))))
    bias = np.asarray(jnp.maximum(
        jattn.causal_mask_bias(s, cap)[None, None]
        + jattn.key_validity_bias(jnp.asarray(valid))[:, None],
        jattn.NEG_INF))
    assert tattn.NEG_INF == jattn.NEG_INF
    for mb in (None, bias[:, 0], bias):
        want = np.asarray(jattn.sdpa(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), d ** -0.5,
                                     None if mb is None else jnp.asarray(mb)))
        got = tattn.sdpa(_t(q), _t(k), _t(v), d ** -0.5,
                         None if mb is None else _t(mb)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_kv_cache_matches_jax():
    rng = np.random.RandomState(3)
    jc = JKVCache.init(TINY_BACKBONE, 2, 10, dtype=jnp.float32)
    tc = TKVCache.init(llama_config_from(TINY_BACKBONE), 2, 10,
                       dtype=torch.float32, device="cpu")
    for s in (4, 1, 1):
        for layer in range(TINY_BACKBONE.num_hidden_layers):
            kn = rng.randn(2, 2, s, 16).astype(np.float32)
            vn = rng.randn(2, 2, s, 16).astype(np.float32)
            jc, jk, jv = jc.update_layer(layer, jnp.asarray(kn),
                                         jnp.asarray(vn))
            tc, tk, tv = tc.update_layer(layer, _t(kn), _t(vn))
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
        jc, tc = jc.advance(s), tc.advance(s)
        assert tc.index == int(jc.index)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)
    with pytest.raises(ValueError, match="overflow"):
        tc.update_layer(0, torch.zeros(2, 2, 5, 16), torch.zeros(2, 2, 5, 16))


PORT_MODULES = [
    "csm_mlx_tpu_torch", "csm_mlx_tpu_torch.config",
    "csm_mlx_tpu_torch.bridge", "csm_mlx_tpu_torch.device",
    "csm_mlx_tpu_torch.generation", "csm_mlx_tpu_torch.tokenizers",
    "csm_mlx_tpu_torch.models", "csm_mlx_tpu_torch.ops",
    "csm_mlx_tpu_torch.ops._build", "csm_mlx_tpu_torch.ops.attention",
    "csm_mlx_tpu_torch.ops.kv_cache", "csm_mlx_tpu_torch.ops.launches",
    "csm_mlx_tpu_torch.ops.layers",
    "csm_mlx_tpu_torch.ops.quant", "csm_mlx_tpu_torch.ops.resident_decoder",
    "csm_mlx_tpu_torch.ops.rope",
    "csm_mlx_tpu_torch.ops.sampling", "csm_mlx_tpu_torch.ops.tensor_parallel",
    "csm_mlx_tpu_torch.models.csm",
    "csm_mlx_tpu_torch.models.llama", "csm_mlx_tpu_torch.models.mimi",
    "csm_mlx_tpu_torch.models.mimi.config", "csm_mlx_tpu_torch.models.mimi.conv",
    "csm_mlx_tpu_torch.models.mimi.mimi", "csm_mlx_tpu_torch.models.mimi.rvq",
    "csm_mlx_tpu_torch.models.mimi.seanet",
    "csm_mlx_tpu_torch.models.mimi.transformer",
    "csm_mlx_tpu_torch.models.mimi.weights", "csm_mlx_tpu_torch.apps",
    "csm_mlx_tpu_torch.apps.voice_chat", "csm_mlx_tpu_torch.apps.stt",
    "csm_mlx_tpu_torch.utils", "csm_mlx_tpu_torch.utils.audio",
    "csm_mlx_tpu_torch.utils.profiling", "csm_mlx_tpu_torch.models.mimi.quant",
    "csm_mlx_tpu_torch.ops.flash_train", "csm_mlx_tpu_torch.loaders",
    "csm_mlx_tpu_torch.safetensors_io", "csm_mlx_tpu_torch.segment",
    "csm_mlx_tpu_torch.finetune", "csm_mlx_tpu_torch.finetune.dataset",
    "csm_mlx_tpu_torch.finetune.lora", "csm_mlx_tpu_torch.finetune.loss",
    "csm_mlx_tpu_torch.finetune.trainer",
    "csm_mlx_tpu_torch.continuous", "csm_mlx_tpu_torch.serve",
    "csm_mlx_tpu_torch.watermark", "csm_mlx_tpu_torch.cli",
    "csm_mlx_tpu_torch.cli.application", "csm_mlx_tpu_torch.cli.config",
    "csm_mlx_tpu_torch.cli.generate", "csm_mlx_tpu_torch.cli.serve",
    "csm_mlx_tpu_torch.__main__", "csm_mlx_tpu_torch.cli.finetune",
    "csm_mlx_tpu_torch.cli.finetune.common",
    "csm_mlx_tpu_torch.cli.finetune.dataset",
    "csm_mlx_tpu_torch.cli.finetune.full_finetune",
    "csm_mlx_tpu_torch.cli.finetune.lora_finetune",
    "csm_mlx_tpu_torch.cli.finetune.utils",
    "csm_mlx_tpu_torch.parallel", "csm_mlx_tpu_torch.parallel.mesh",
    "csm_mlx_tpu_torch.parallel.pipeline",
    "csm_mlx_tpu_torch.parallel.sequence",
]


def test_port_imports_no_jax():
    """Every module of the port imports with jax, transformers and
    safetensors made unimportable, and none of them gets loaded."""
    pkg = Path(__file__).resolve().parent.parent / "csm_mlx_tpu_torch"
    found = sorted(
        ".".join(p.relative_to(pkg.parent).with_suffix("").parts).replace(
            ".__init__", "")
        for p in pkg.rglob("*.py"))
    assert found == sorted(PORT_MODULES)
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'transformers', 'safetensors'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.startswith('csm_mlx_tpu.') or k == 'csm_mlx_tpu'\n"
        "               for k in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=pkg.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("fn,kw", [
    ("conv1d", dict(stride=2, dilation=1, groups=1)),
    ("conv1d", dict(stride=1, dilation=3, groups=2)),
    ("causal_conv1d", dict(stride=2, dilation=1, groups=1)),
    ("conv_transpose1d", dict(stride=3, groups=1)),
    ("causal_conv_transpose1d", dict(stride=2, groups=4)),
])
def test_mimi_convs_match_jax(fn, kw):
    from csm_mlx_tpu.models.mimi import conv as jconv
    from csm_mlx_tpu_torch.models.mimi import conv as tconv

    rng = np.random.RandomState(len(fn) + kw["stride"])
    c_in, c_out, k, g = 8, 12, 5, kw["groups"]
    if "transpose" in fn:
        w = rng.randn(c_in, c_out // g, k).astype(np.float32)
    else:
        w = rng.randn(c_out, c_in // g, k).astype(np.float32)
    p = {"weight": w, "bias": rng.randn(c_out).astype(np.float32)}
    x = rng.randn(2, c_in, 17).astype(np.float32)
    want = np.asarray(getattr(jconv, fn)(
        {k_: jnp.asarray(v) for k_, v in p.items()}, jnp.asarray(x), **kw))
    got = getattr(tconv, fn)(to_torch(p), _t(x), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_sampler_greedy_and_temperature():
    from csm_mlx_tpu.ops.sampling import SamplerConfig as JSampler
    from csm_mlx_tpu_torch.ops.sampling import SamplerConfig

    logits = np.random.RandomState(4).randn(3, 50).astype(np.float32)
    logits[1, [7, 9]] = 10.0  # a tie: both take the first index
    np.testing.assert_array_equal(
        SamplerConfig(temperature=0.0)(None, _t(logits)).numpy(),
        np.asarray(JSampler(temperature=0.0)(None, jnp.asarray(logits))))
    smp = SamplerConfig(temperature=0.7)
    draw = [smp(torch.Generator().manual_seed(1), _t(logits)) for _ in range(2)]
    torch.testing.assert_close(draw[0], draw[1])  # seeded: reproducible
    assert draw[0].shape == (3,) and int(draw[0].max()) < 50
    # top-k filters: every draw is one of the row's 5 largest logits
    top5 = np.argsort(-logits, axis=-1)[:, :5]
    gen = torch.Generator().manual_seed(2)
    for _ in range(20):
        got = SamplerConfig(temperature=1.0, top_k=5)(gen, _t(logits)).numpy()
        assert all(g in row for g, row in zip(got, top5))

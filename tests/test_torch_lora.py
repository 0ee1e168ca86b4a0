"""The port's LoRA / DoRA (`ops.layers.linear`, `finetune.lora`) against the
JAX package's on the tiny config, fp32: adapted forwards, effective
weights, fusing, refusals, and adapter files read by the other package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_args
from csm_mlx_tpu.finetune import lora as jax_lora
from csm_mlx_tpu.finetune.loss import compute_loss as jax_compute_loss
from csm_mlx_tpu.loaders import tree_to_flat as jax_flat
from csm_mlx_tpu.models.csm import CSM as JaxCSM
from csm_mlx_tpu_torch.finetune import lora
from csm_mlx_tpu_torch.finetune.loss import compute_loss
from csm_mlx_tpu_torch.loaders import tree_to_flat
from csm_mlx_tpu_torch.models.csm import CSM, ModelArgs
from csm_mlx_tpu_torch.models.llama import fuse_layer_weights
from csm_mlx_tpu_torch.ops import layers
from csm_mlx_tpu_torch.ops.quant import quantize_model
from test_torch_loss import make_batch
from torch_helpers import to_torch, torch_model_from_jax

CFG = {"rank": 2, "scale": 2.0, "dropout": 0.0, "keys": ["attn"]}


def jax_adapted(use_dora, seed=0):
    """A JAX tiny model with LoRA/DoRA on the default keys and random (so
    nonzero) lora_b and a random audio_head."""
    model = JaxCSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(seed))
    jax_lora.linear_to_lora_layers(model, CFG, use_dora=use_dora)
    rng = np.random.RandomState(seed + 1)

    def visit(tree):
        if isinstance(tree, dict):
            if "lora_b" in tree:
                tree["lora_b"] = jnp.asarray(
                    rng.randn(*tree["lora_b"].shape).astype(np.float32) * 0.1)
            for v in tree.values():
                visit(v)
        elif isinstance(tree, list):
            for v in tree:
                visit(v)

    visit(model.params)
    head = model.params["audio_head"]
    model.params["audio_head"] = jnp.asarray(
        rng.randn(*head.shape).astype(np.float32) * 0.5)
    return model


def cpu_model(seed=0) -> CSM:
    """A random tiny model of the port on the CPU (its own init)."""
    a = tiny_args()
    args = ModelArgs(a.backbone_name, a.decoder_name, a.n_text_vocab,
                     a.n_audio_vocab, a.n_audio_codebooks)
    return CSM(args, dtype=torch.float32,
               generator=torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("use_dora", [False, True])
def test_adapted_loss_and_weights_match_jax(use_dora):
    """A JAX-adapted tree carried by bridge.py (lora_scale and dora_m
    included): compute_loss through the adapted linears, effective_weight
    of every adapted leaf, and fuse_lora agree with JAX within 1e-5."""
    jm = jax_adapted(use_dora)
    model = torch_model_from_jax(jm)
    p = model.params["backbone"]["layers"][0]["self_attn"]["q_proj"]
    assert p["lora_scale"].dtype == torch.float32 and p["lora_scale"].dim() == 0
    assert ("dora_m" in p) == use_dora
    batch = make_batch(jm.args, seed=3)
    want = float(jax_compute_loss(jm.params, jm.args,
                                  {k: jnp.asarray(v) for k, v in batch.items()}))
    got = float(compute_loss(model.params, model.args,
                             {k: torch.from_numpy(v) for k, v in batch.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jp = jm.params["backbone"]["layers"][0]["self_attn"]["q_proj"]
    np.testing.assert_allclose(lora.effective_weight(p).numpy(),
                               np.asarray(jax_lora.effective_weight(jp)),
                               rtol=1e-5, atol=1e-6)
    lora.fuse_lora(model)
    jax_lora.fuse_lora(jm)
    got_flat, want_flat = tree_to_flat(model.params), jax_flat(jm.params)
    assert set(got_flat) == set(want_flat)
    assert not any("lora" in k or "dora" in k for k in got_flat)
    for k, v in got_flat.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want_flat[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("use_dora", [False, True])
def test_zero_init_leaves_forward_unchanged(use_dora):
    model = cpu_model(1)
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(model.args, seed=4).items()}
    before = compute_loss(model.params, model.args, batch)
    lora.linear_to_lora_layers(model, CFG, use_dora=use_dora)
    flat = tree_to_flat(model.params)
    assert sum(k.endswith("lora_a") for k in flat) == 7 * 4
    assert all(not v.any() for k, v in flat.items() if k.endswith("lora_b"))
    after = compute_loss(model.params, model.args, batch)
    torch.testing.assert_close(after, before, rtol=1e-6, atol=1e-6)


def test_conversion_refuses_quantized_and_fused_models():
    model = cpu_model(2)
    quantize_model(model, mode="w8a8", min_size=1, fuse=False)
    with pytest.raises(ValueError, match="BEFORE quantize"):
        lora.linear_to_lora_layers(model, CFG)
    fused = cpu_model(3)
    fuse_layer_weights(fused.params["backbone"])
    fuse_layer_weights(fused.params["decoder"])
    with pytest.raises(ValueError, match="BEFORE quantize"):
        lora.linear_to_lora_layers(fused, CFG)


def test_quantized_dora_leaf_raises():
    from csm_mlx_tpu_torch.ops.quant import quantize_weight_w8

    leaf = dict(quantize_weight_w8(torch.randn(16, 32)),
                dora_m=torch.ones(16))
    with pytest.raises(ValueError, match="quantized DoRA"):
        layers.linear(leaf, torch.randn(2, 32))


def test_dropout_is_live_only_in_scope_and_replays():
    """Dropout on the adapter input is the identity outside a
    lora_dropout_rng scope; inside, masks follow the generator, and a
    dropout_replay of a snapshot draws the same masks again (remat)."""
    model = cpu_model(5)
    lora.linear_to_lora_layers(model, dict(CFG, dropout=0.5), use_dora=True)
    lp = model.params["decoder"]["layers"][-1]["self_attn"]["q_proj"]
    lp["lora_b"] = torch.randn(lp["lora_b"].shape,
                               generator=torch.Generator().manual_seed(6)) * 0.1
    x = torch.randn((4, lp["weight"].shape[1]),
                    generator=torch.Generator().manual_seed(7))
    y_eval = layers.linear(lp, x)
    torch.testing.assert_close(
        y_eval, x @ lora.effective_weight(lp).t(), rtol=1e-5, atol=1e-6)
    with layers.lora_dropout_rng(torch.Generator().manual_seed(8)):
        snap = layers.dropout_snapshot()
        y1 = layers.linear(lp, x)
        with layers.dropout_replay(snap):
            y_replay = layers.linear(lp, x)
        y2 = layers.linear(lp, x)
    assert not torch.allclose(y1, y_eval) and not torch.allclose(y1, y2)
    torch.testing.assert_close(y_replay, y1, rtol=0, atol=0)


def test_adapter_files_cross_load(tmp_path):
    """Adapters written by the port load in JAX's load_adapters, and JAX's
    load in the port's: the adapter leaves arrive bit-equal."""
    jm = jax_adapted(use_dora=True, seed=7)
    jax_lora.save_adapters(jm, str(tmp_path / "from_jax"), CFG,
                           fine_tune_type="dora")
    port = cpu_model(8)
    lora.load_adapters(port, str(tmp_path / "from_jax"))
    got = {k: v for k, v in tree_to_flat(port.params).items()
           if lora.trainable_filter(k)}
    want = {k: v for k, v in jax_flat(jm.params).items()
            if jax_lora.trainable_filter(k)}
    assert set(got) == set(want) and len(got) == 3 * 7 * 4
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))

    for v in got.values():
        v.add_(0.25)  # move them, so the way back is a real check
    lora.save_adapters(port, str(tmp_path / "from_port"), CFG,
                       fine_tune_type="dora")
    fresh = JaxCSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(9))
    jax_lora.load_adapters(fresh, str(tmp_path / "from_port"))
    back = {k: v for k, v in jax_flat(fresh.params).items()
            if jax_lora.trainable_filter(k)}
    assert set(back) == set(got)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v.numpy())

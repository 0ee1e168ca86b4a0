"""The port's `compute_loss` against the JAX `compute_loss`: value and
gradients on every parameter leaf (jax.grad against torch autograd), on
the tiny config in fp32 with the same parameters (carried by `bridge.py`)
and the same seeded batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_args
from csm_mlx_tpu.finetune.loss import compute_loss as jax_loss
from csm_mlx_tpu.loaders import tree_to_flat as jax_flat
from csm_mlx_tpu.models.csm import CSM as JaxCSM
from csm_mlx_tpu_torch.finetune.loss import compute_loss
from csm_mlx_tpu_torch.loaders import tree_to_flat
from torch_helpers import to_torch

# fp32 through 2 + 2 layers and a 64-way CE, sum order only: values within
# rtol 1e-4, and each gradient leaf within 1e-4 of its largest magnitude
RTOL, ATOL = 1e-4, 1e-6


def assert_grads_close(got_g, want_g):
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        want = want_g[name]
        np.testing.assert_allclose(g.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(),
                                   err_msg=name)


def make_batch(args, b=2, s=7, seed=0, partial=False):
    rng = np.random.RandomState(seed)
    k = args.n_audio_codebooks + 1
    tokens = rng.randint(0, args.n_audio_vocab, size=(b, s, k)).astype(np.int32)
    tokens[..., -1] = rng.randint(0, args.n_text_vocab, size=(b, s))
    masks = np.ones((b, s, k), dtype=np.int32)
    masks[:, -1] = 0  # the last frame of each row is padding
    loss_masks = np.ones((b, s, k), dtype=np.int32)
    if partial:
        loss_masks[0, :3] = 0
        loss_masks[1, :, 4:] = 0
        masks[1, 2, :5] = 0
    return {"tokens": tokens, "masks": masks, "loss_masks": loss_masks}


@pytest.fixture(scope="module")
def models():
    jm = JaxCSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    head = jm.params["audio_head"]
    jm.params["audio_head"] = jnp.asarray(
        rng.randn(*head.shape).astype(np.float32) * 0.5)
    return jm, to_torch(jm.params)


def torch_loss_and_grads(params, args, batch, **kw):
    flat = tree_to_flat(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss = compute_loss(params, args, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, **kw)
    grads = torch.autograd.grad(loss.sum(), list(flat.values()))
    for t in flat.values():
        t.requires_grad_(False)
    return loss.detach().numpy(), dict(zip(flat, grads))


def jax_loss_and_grads(params, args, batch, **kw):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    value = jax_loss(params, args, jb, **kw)
    grads = jax.grad(lambda p: jax_loss(p, args, jb, **kw).sum())(params)
    return np.asarray(value), {k: np.asarray(v)
                               for k, v in jax_flat(grads).items()}


CASES = {
    "default": ({}, False),
    "per_sample": ({"per_sample": True}, False),
    "cause_mismatch": ({"per_sample": True, "cause_mismatch": True}, False),
    "fcw_partial_mask": ({"first_codebook_weight_multiplier": 2.5}, True),
    "remat": ({"remat": True}, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compute_loss_and_grads_match_jax(models, case, monkeypatch):
    monkeypatch.setenv("CSM_TPU_FLASH_TRAIN", "512")
    jm, params = models
    kw, partial = CASES[case]
    batch = make_batch(jm.args, seed=len(case), partial=partial)
    want, want_g = jax_loss_and_grads(jm.params, jm.args, batch, **kw)
    got, got_g = torch_loss_and_grads(params, jm.args, batch, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert_grads_close(got_g, want_g)


def test_compute_loss_flash_path_matches_jax(models, monkeypatch):
    """flash_min_len=1 sends the backbone through the flash pair (its plain
    versions here) and CSM_TPU_FLASH_TRAIN=1 sends JAX's through its Pallas
    pair in interpret mode: same value and gradients; the port's einsum
    path (flash_min_len=0) agrees too."""
    monkeypatch.setenv("CSM_TPU_FLASH_TRAIN", "1")
    jm, params = models
    batch = make_batch(jm.args, seed=11, partial=True)
    want, want_g = jax_loss_and_grads(jm.params, jm.args, batch)
    for min_len in (1, 0):
        got, got_g = torch_loss_and_grads(params, jm.args, batch,
                                          flash_min_len=min_len)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert_grads_close(got_g, want_g)


def test_decoder_loss_fraction_needs_a_generator(models):
    jm, params = models
    batch = {k: torch.from_numpy(v) for k, v in make_batch(jm.args).items()}
    with pytest.raises(ValueError, match="generator"):
        compute_loss(params, jm.args, batch, decoder_loss_fraction=0.5)
    with pytest.raises(ValueError, match="per-sample"):
        compute_loss(params, jm.args, batch, decoder_loss_fraction=0.5,
                     per_sample=True, generator=torch.Generator())
    losses = [float(compute_loss(params, jm.args, batch,
                                 decoder_loss_fraction=0.5,
                                 generator=torch.Generator().manual_seed(s)))
              for s in (1, 1, 2)]
    full = float(compute_loss(params, jm.args, batch))
    assert losses[0] == losses[1] and losses[0] != losses[2]
    assert all(np.isfinite(losses)) and losses[0] != full

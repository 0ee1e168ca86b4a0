"""Kernels 6 and 7's plain versions (the port's flash-attention pair for
training) against the JAX `flash_attention` (Pallas, interpret mode on the
CPU) and against autograd through the masked `sdpa`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (one intra-op thread)
from csm_mlx_tpu.ops.flash_train import flash_attention as jax_flash
from csm_mlx_tpu_torch.ops import flash_train
from csm_mlx_tpu_torch.ops.attention import causal_mask_bias, sdpa

B, H, KV, D = 2, 4, 2, 16
SCALE = D ** -0.5


def _inputs(s, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((B, H, s, D), (B, KV, s, D), (B, KV, s, D),
                          (B, H, s, D))]




@pytest.mark.parametrize("s", [128, 200])  # 200: a ragged tail
def test_plain_pair_matches_jax_flash_attention(s):
    """Forward and dq/dk/dv of the port's plain pair against the JAX Pallas
    pair under the same cotangent; rtol/atol 3e-5 (fp32, sum order)."""
    q, k, v, w = _inputs(s, s)
    out_j, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, SCALE),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(w))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_train.flash_train_fwd(tq, tk, tv, SCALE)
    grads = flash_train.flash_train_bwd(tq, tk, tv, out, lse,
                                        torch.from_numpy(w), SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=3e-5,
                               atol=3e-5)
    for name, got, want in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                                   atol=3e-5, err_msg=f"d{name} at S={s}")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("s", [128, 200])
def test_flash_attention_grads_match_sdpa_autograd(s, remat):
    """`flash_attention` (the autograd.Function over the pair) against
    autograd through the masked sdpa, with q/k/v as transposed views as the
    model makes them, plain and under torch.utils.checkpoint; 3e-5."""
    q, k, v, w = _inputs(s, s + 1)

    def leaves():
        return [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
                .requires_grad_(True) for x in (q, k, v)]

    def loss(fn, a, b, c):
        out = fn(a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2))
        return (out * torch.from_numpy(w)).sum() + torch.tanh(out).sum()

    def flash(a, b, c):
        return flash_train.flash_attention(a, b, c, SCALE)

    def ref(a, b, c):
        return sdpa(a, b, c, SCALE, causal_mask_bias(s, s)[None, None])

    fl = leaves()
    if remat:
        out = torch.utils.checkpoint.checkpoint(
            lambda *t: loss(flash, *t), *fl, use_reentrant=False)
    else:
        out = loss(flash, *fl)
    got = torch.autograd.grad(out, fl)
    rf = leaves()
    want = torch.autograd.grad(loss(ref, *rf), rf)
    for name, g, r in zip("qkv", got, want):
        torch.testing.assert_close(g, r, rtol=3e-5, atol=3e-5,
                                   msg=f"d{name} at S={s}")


def test_plain_pair_bf16_types():
    """bf16 inputs: O and dq in q's type, dk/dv summed in fp32 and cast to
    k's type, lse fp32; within bf16 rounding (2e-2) of the fp32 pair."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(70, 5))
    out, lse = flash_train.flash_train_fwd(*(t.bfloat16() for t in (q, k, v)),
                                           SCALE)
    grads = flash_train.flash_train_bwd(*(t.bfloat16() for t in (q, k, v)),
                                        out, lse, w.bfloat16(), SCALE)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert all(g.dtype == torch.bfloat16 for g in grads)
    ref_out, _ = flash_train.flash_train_fwd(q, k, v, SCALE)
    ref = flash_train.flash_train_bwd(q, k, v, ref_out, None, w, SCALE)
    for got, want in zip((out, *grads), (ref_out, *ref)):
        torch.testing.assert_close(got.float(), want, rtol=2e-2,
                                   atol=2e-2 * want.abs().max().item())


def test_wrapper_counts_only_card_launches():
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(64, 6))
    before = (flash_train.flash_train_fwd.launches,
              flash_train.flash_train_bwd.launches)
    out = flash_train.flash_attention(q.requires_grad_(True), k, v, SCALE)
    out.sum().backward()
    assert (flash_train.flash_train_fwd.launches,
            flash_train.flash_train_bwd.launches) == before

"""PyTorch port vs JAX package: W8A8 quantization and kernel 1 (the W8A8
matvec). On the CPU the port's wrapper runs its plain version; the JAX
Pallas kernel runs in interpret mode, as its own tests run it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_args
from torch_helpers import to_torch, torch_model_from_jax
from csm_mlx_tpu.models.csm import CSM as JCSM
from csm_mlx_tpu.ops import quant as jquant
from csm_mlx_tpu_torch.ops import quant as tquant

# The int32 products are exact on both sides; only the fp32 fix-up and the
# fp32 row sum may differ in their last bits.
RTOL = 1e-5


def _weights(seed, out_dim=256, in_dim=256, rows=1):
    rng = np.random.RandomState(seed)
    w = (rng.randn(out_dim, in_dim) * 0.1).astype(np.float32)
    x = rng.randn(rows, in_dim).astype(np.float32)
    return w, x


def test_quantize_weight_w8_codes_equal_jax():
    w, _ = _weights(0, 192, 320)
    w[5] = 0.25  # a constant row: scale clamps to 1e-12
    eager = jax.device_get(jquant.quantize_weight_w8(jnp.asarray(w)))
    jitted = jax.device_get(
        jquant._jitted_quantizer("w8a8", 8, 64)(jnp.asarray(w)))
    tq = tquant.quantize_weight_w8(torch.from_numpy(w))
    assert tq["weight_q"].dtype == torch.int8
    np.testing.assert_array_equal(tq["weight_q"].numpy(), eager["weight_q"])
    # quantize_model's jitted quantizer: equal to the bit
    for k in ("weight_q", "scales", "biases"):
        np.testing.assert_array_equal(tq[k].numpy(), jitted[k])
    # the eager call divides by 254 instead: scales within one ulp
    np.testing.assert_allclose(tq["scales"].numpy(), eager["scales"],
                               rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("rows", [1, 8, 64])
def test_w8a8_plain_matches_jax_mirror_and_pallas_interpret(rows):
    w, x = _weights(rows, rows=rows)
    jq = jquant.quantize_weight_w8(jnp.asarray(w))
    mirror = np.asarray(jquant._xla_w8a8_matvec(
        jnp.asarray(x), jq["weight_q"], jq["scales"], jq["biases"]))
    pallas = np.asarray(jquant._pallas_quant_matvec_w8a8(
        jnp.asarray(x), jq["weight_q"], jq["scales"], jq["biases"], bits=8,
        group_size=256))
    tq = to_torch(jq)
    got = tquant.w8a8_matvec(torch.from_numpy(x), tq["weight_q"],
                             tq["scales"], tq["biases"]).numpy()
    scale = np.abs(mirror).max()
    np.testing.assert_allclose(got, mirror, rtol=RTOL, atol=RTOL * scale)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("rows", [384, 65, 300])
def test_w8a8_large_batch_matches_jax_route(rows):
    """Past 64 rows the JAX package routes them through its int8 XLA mirror
    (quant_linear's large-batch branch); the port through the same
    arithmetic as at any other row count (on the card, the tensor-core GEMM
    route of kernel 1).

    The activations lie on the int8 grid (k / 127 with a row max of 1), so
    that every code is far from a rounding boundary: XLA's CPU division
    behind `127 / absmax` differs from IEEE division in the last bit at
    this shape (the B <= 64 test above meets none of it), which moves a
    few off-grid codes by one step."""
    w, _ = _weights(17)
    rng = np.random.RandomState(18)
    x = rng.randint(-127, 128, size=(rows, 256)).astype(np.float32)
    x[:, 0] = 127.0
    x /= 127.0
    jq = jquant.quantize_weight_w8(jnp.asarray(w))
    want = np.asarray(jquant.quant_linear(dict(jq), jnp.asarray(x)))
    got = tquant.quant_linear(to_torch(jq), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_quantize_model_matches_jax_layout():
    jm = JCSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(5))
    tm = torch_model_from_jax(jm)
    jquant.quantize_model(jm, mode="w8a8", min_size=0)
    tquant.quantize_model(tm, mode="w8a8", min_size=0)
    jp = jax.device_get(jm.params)

    def compare(j, t, path):
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                compare(j[k], t[k], f"{path}.{k}")
        elif isinstance(j, list):
            for i, (a, b) in enumerate(zip(j, t)):
                compare(a, b, f"{path}.{i}")
        else:
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(j), err_msg=path)

    compare(jp, tm.params, "params")
    attn = tm.params["backbone"]["layers"][0]["self_attn"]
    assert "qkv_proj" in attn and attn["qkv_proj"]["weight_q"].dtype == \
        torch.int8
    assert "gateup_proj" in tm.params["decoder"]["layers"][1]["mlp"]

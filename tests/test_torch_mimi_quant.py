"""PyTorch port vs JAX package: the int8 Mimi decode path
(`csm_mlx_tpu_torch/models/mimi/quant.py` and the quantized convs of
`models/mimi/conv.py`) on the tiny codec config (`tests/test_mimi.py::
TINY`), the JAX codec's parameters carried over.

JAX's cases of `tests/test_mimi_quant.py` on the port (the quantized
decode against the fp32 one within 0.12 relative RMSE, streamed against
batched within 0.05, the encoder untouched, idempotence, the grouped
upsample left fp32, the streaming state contract, partial targets), and
against JAX on the same parameters and codes: the SEANet codes and scales
bit-equal; the transformer's codes equal and its scales within one fp32
step (JAX quantizes the codec eagerly, a true division by 254; the port's
`quantize_weight_w8` multiplies by its fp32 reciprocal, as JAX's jitted
model quantizer does); the quantized batch and streamed decodes within
1e-4 of the waveform's peak (the fp32 decode tests' tolerance). The int8
GEMM forms that the card runs (`_conv1d_gemm`, `_conv_transpose1d_gemm`)
are held to the plain sums bit for bit here, through an int64 matmul that
checks `torch._int_mm`'s shape rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_mimi import TINY
from torch_helpers import to_torch
from csm_mlx_tpu.models.mimi import Mimi as JMimi
from csm_mlx_tpu.models.mimi.quant import \
    quantize_mimi_decoder as jax_quantize
from csm_mlx_tpu_torch.bridge import mimi_config_from
from csm_mlx_tpu_torch.loaders import tree_to_flat
from csm_mlx_tpu_torch.models.mimi import Mimi
from csm_mlx_tpu_torch.models.mimi import conv
from csm_mlx_tpu_torch.models.mimi.mimi import (mimi_decode_step_fn,
                                                reset_decode_row)
from csm_mlx_tpu_torch.models.mimi.quant import (mimi_decoder_is_quantized,
                                                 quantize_mimi_decoder)

JAX_ATOL = 1e-4  # of the waveform's peak


@pytest.fixture(scope="module")
def jax_pair():
    f32 = JMimi(TINY, rng=jax.random.PRNGKey(7))
    q = JMimi(TINY, params=jax.tree_util.tree_map(lambda a: a, f32.params),
              rng=jax.random.PRNGKey(7))
    jax_quantize(q)
    return f32, q


@pytest.fixture()
def quant_pair(jax_pair):
    cfg = mimi_config_from(TINY)
    f32 = Mimi(cfg, params=to_torch(jax_pair[0].params))
    q = Mimi(cfg, params=to_torch(jax_pair[0].params))
    quantize_mimi_decoder(q)
    return f32, q


def _codes(b, f, seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, TINY.codebook_size, (b, TINY.num_quantizers, f)))


def _rel_rmse(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / (np.sqrt(np.mean(a ** 2)) + 1e-12))


def test_quantized_decode_close_to_f32(quant_pair):
    f32, q = quant_pair
    codes = _codes(2, 6, 0)
    a, b = f32.decode(codes), q.decode(codes)
    assert a.shape == b.shape
    rel = _rel_rmse(a, b)
    # a few percent of int8 error; a wrong scale axis, a double bias or a
    # flipped kernel lands at O(1)
    assert 0 < rel < 0.12, rel


def test_quantized_streaming_matches_quantized_batch(quant_pair):
    """The streamed decode quantizes each chunk's activations afresh, so it
    is not bit-equal to the batch decode, but within the order of the
    quantization noise."""
    _, q = quant_pair
    f = 6
    codes = _codes(1, f, 1)
    full = q.decode(codes)
    state = q.init_decode_state(1)
    chunks = []
    for i in range(f):
        c, state = q.decode_step(codes[:, :, i:i + 1], state)
        chunks.append(c)
    assert _rel_rmse(full, torch.cat(chunks, dim=-1)) < 0.05


def test_encoder_untouched_and_idempotent(quant_pair):
    f32, q = quant_pair
    audio = torch.from_numpy(np.random.RandomState(2).randn(
        1, 1, TINY.frame_size * 4).astype(np.float32))
    assert torch.equal(f32.encode(audio), q.encode(audio))
    assert "weight_q" not in q.params["encoder"]["init"]
    assert not any("weight_q" in k for k in tree_to_flat(q.params["quantizer"]))
    assert mimi_decoder_is_quantized(q.params)
    before = {k: v for k, v in tree_to_flat(q.params).items()}
    quantize_mimi_decoder(q)  # a second call changes nothing
    after = tree_to_flat(q.params)
    assert after.keys() == before.keys()
    assert all(after[k] is v for k, v in before.items())


def test_grouped_upsample_stays_f32(quant_pair):
    _, q = quant_pair
    assert "weight_q" not in q.params["upsample"]
    lp = q.params["decoder_transformer"]["layers"][0]
    assert "weight_q" in lp["self_attn"]["q_proj"]
    assert "weight_q" in lp["mlp"]["fc1"]
    assert lp["self_attn"]["q_proj"]["weight_q"].dtype == torch.int8


def test_quant_decode_state_contract_unchanged(quant_pair):
    """reset_decode_row and block decode work on the quantized tree (the
    continuous engine recycles rows through both)."""
    _, q = quant_pair
    codes = _codes(2, 3, 3)
    st = q.init_decode_state(2, chunk_frames=3)
    audio, st = mimi_decode_step_fn(q.params, q.cfg, codes, st)
    assert audio.shape == (2, 1, 3 * TINY.frame_size)
    st = reset_decode_row(st, 1)
    audio2, _ = mimi_decode_step_fn(q.params, q.cfg, codes, st)
    assert audio2.shape == audio.shape


@pytest.mark.parametrize("targets,seanet,transformer", [
    (("transformer",), False, True),
    (("seanet",), True, False),
])
def test_partial_targets(jax_pair, targets, seanet, transformer):
    m = Mimi(mimi_config_from(TINY), params=to_torch(jax_pair[0].params))
    quantize_mimi_decoder(m, targets=targets)
    assert ("weight_q" in m.params["decoder"]["init"]) == seanet
    assert ("weight_q" in m.params["decoder"]["stages"][0]["up"]) == seanet
    assert ("weight_q" in m.params["decoder_transformer"]["layers"][0][
        "self_attn"]["q_proj"]) == transformer


def test_codes_and_scales_equal_jax(jax_pair, quant_pair):
    """The same leaves as JAX's quantized tree: SEANet codes and scales
    bit-equal, transformer codes equal and scales within one fp32 step
    (see the module docstring)."""
    got = {k: v.numpy() for k, v in tree_to_flat(quant_pair[1].params).items()}
    want = {k: np.asarray(v) for k, v in tree_to_flat(
        to_torch(jax_pair[1].params)).items()}
    assert got.keys() == want.keys()
    n_quantized = 0
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if k.startswith("decoder_transformer") and k.endswith(".scales"):
            np.testing.assert_allclose(got[k], w, rtol=2.0 ** -23, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        n_quantized += k.endswith("weight_q")
    # init, 2 stages x (up, conv1, conv2), final; 2 layers x 6 linears
    assert n_quantized == 2 + 3 * len(TINY.upsampling_ratios) + 12


def test_quantized_decodes_match_jax(jax_pair, quant_pair):
    """The port's quantized batch decode (padded to JAX's frame bucket, as
    JAX decodes) and its streamed decode against JAX's on the same
    codes."""
    jq, q = jax_pair[1], quant_pair[1]
    codes = _codes(2, 6, 4)
    want = np.asarray(jq.decode(jnp.asarray(codes.numpy())))
    got = q.decode(codes).numpy()
    np.testing.assert_allclose(got, want,
                               atol=JAX_ATOL * np.abs(want).max())
    jstate, state = jq.init_decode_state(2), q.init_decode_state(2)
    for i in range(codes.shape[-1]):
        w, jstate = jq.decode_step(jnp.asarray(codes[:, :, i:i + 1].numpy()),
                                   jstate)
        g, state = q.decode_step(codes[:, :, i:i + 1], state)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=JAX_ATOL * np.abs(want).max())


def _int_mm_rules(a, b):
    """`torch._int_mm`'s shape rules, then the exact product (int64)."""
    assert a.dtype == b.dtype == torch.int8
    assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
    assert b.stride(0) == 1  # the transpose of a row-major matrix
    return (a.long() @ b.long()).int()


def _padded_on_cpu(a, w):
    return conv._int_mm_padded(a, w, int_mm=_int_mm_rules)


@pytest.mark.parametrize("b,c_in,c_out,k,t,stride,dilation", [
    (2, 16, 16, 7, 20, 1, 1),    # the init conv's shape class
    (1, 8, 4, 3, 9, 1, 3),       # a dilated residual conv, one row
    (3, 4, 6, 4, 11, 2, 1),      # strided, K not a multiple of 8
    (1, 4, 1, 3, 5, 1, 1),       # the final conv: one output channel
])
def test_int8_conv_gemm_equals_plain_sums(b, c_in, c_out, k, t, stride,
                                          dilation):
    g = torch.Generator().manual_seed(b * 100 + c_in + k)
    xq = torch.randint(-127, 128, (b, c_in, t), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (c_out, c_in, k), generator=g).to(
        torch.int8)
    got = conv._conv1d_gemm(xq, wq, stride, dilation, mm=_padded_on_cpu)
    want = conv.int8_conv1d_sums(xq, wq, stride, dilation)  # CPU: plain
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("b,c_in,c_out,k,t,stride", [
    (2, 16, 8, 16, 6, 8),   # a SEANet upsampler: K = 2 * stride
    (1, 4, 2, 5, 3, 2),     # K not a multiple of the stride
    (2, 3, 3, 4, 7, 4),     # K = stride: no overlap
    (1, 2, 8, 3, 1, 3),     # one sample
])
def test_int8_conv_transpose_gemm_equals_plain_sums(b, c_in, c_out, k, t,
                                                    stride):
    g = torch.Generator().manual_seed(b * 100 + c_in + k + 1)
    xq = torch.randint(-127, 128, (b, c_in, t), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (c_in, c_out, k), generator=g).to(
        torch.int8)
    got = conv._conv_transpose1d_gemm(xq, wq, stride, mm=_padded_on_cpu)
    want = conv.int8_conv_transpose1d_sums(xq, wq, stride)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_full_size_streamed_against_batched_equals_jax():
    """Mimi(32) at its real size (random weights, the port's init carried
    to JAX): JAX's streamed-against-batched case (6 frames) gives the same
    relative RMSE in both packages. At this size it is ~0.057 in JAX too,
    past the 0.05 that JAX's test holds on its tiny codec: a property of
    the per-chunk activation scale, which `chip_smoke.py` reports."""
    from torch_helpers import to_jax
    from csm_mlx_tpu.models.mimi import mimi_202407 as jax_mimi_202407
    from csm_mlx_tpu_torch.models.mimi import mimi_202407

    port = Mimi(mimi_202407(32), device="cpu",
                generator=torch.Generator().manual_seed(2))
    jm = JMimi(jax_mimi_202407(32), params=to_jax(port.params))
    quantize_mimi_decoder(port)
    jax_quantize(jm)
    codes = np.random.RandomState(0).randint(0, 2048, (1, 32, 6))
    got_full = port.decode(torch.from_numpy(codes))
    want_full = np.asarray(jm.decode(jnp.asarray(codes)))
    state, jstate = port.init_decode_state(1), jm.init_decode_state(1)
    got, want = [], []
    for i in range(codes.shape[-1]):
        c = codes[:, :, i:i + 1]
        chunk, state = port.decode_step(torch.from_numpy(c), state)
        got.append(chunk)
        jchunk, jstate = jm.decode_step(jnp.asarray(c), jstate)
        want.append(np.asarray(jchunk))
    r_port = _rel_rmse(torch.cat(got, dim=-1), got_full)
    r_jax = _rel_rmse(np.concatenate(want, axis=-1), want_full)
    assert abs(r_port - r_jax) < 1e-3 * r_jax + 1e-4, (r_port, r_jax)

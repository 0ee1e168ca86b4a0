"""PyTorch port vs JAX package: Mimi's streaming decoder on the tiny codec
config (`tests/test_mimi.py::TINY`) — `decode_step` frame by frame and in
blocks, ring eviction past the window, `reset_decode_row`, and the
stateful `decode_step` / `reset_state`, against JAX's `decode_step` and the
port's own batch decode. Codes are made with numpy from a seed.

Tolerances: atol 1e-4 against JAX, as `test_mimi_decode_matches_jax`
(fp32 on both sides, sums in other orders); rtol 1e-4 / atol 1e-5 between
the port's chunks and its batch decode, as JAX's own test holds its
stream to its batch decode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_mimi import TINY
from torch_helpers import to_torch
from csm_mlx_tpu.models.mimi import Mimi as JMimi
from csm_mlx_tpu.models.mimi.mimi import reset_decode_row as jreset_row
from csm_mlx_tpu_torch.bridge import mimi_config_from
from csm_mlx_tpu_torch.models.mimi import Mimi as TMimi
from csm_mlx_tpu_torch.models.mimi.conv import (
    causal_conv1d_streaming, causal_conv_transpose1d_streaming,
    make_conv_state, make_convtr_state)
from csm_mlx_tpu_torch.models.mimi.mimi import reset_decode_row

JAX_ATOL = 1e-4


@pytest.fixture(scope="module")
def mimis():
    jm = JMimi(TINY, rng=jax.random.PRNGKey(7))
    tm = TMimi(mimi_config_from(TINY), params=to_torch(jm.params))
    return jm, tm


def _codes(b, f, seed):
    return np.random.RandomState(seed).randint(
        0, TINY.codebook_size, size=(b, TINY.num_quantizers, f))


def _jax_stream(jm, codes, block=1, state=None):
    state = state or jm.init_decode_state(batch=codes.shape[0],
                                          chunk_frames=block)
    out = []
    for i in range(0, codes.shape[-1], block):
        chunk, state = jm.decode_step(jnp.asarray(codes[:, :, i:i + block]),
                                      state)
        out.append(np.asarray(chunk))
    return np.concatenate(out, axis=-1), state


def _port_stream(tm, codes, block=1, state=None):
    state = state or tm.init_decode_state(batch=codes.shape[0],
                                          chunk_frames=block)
    out = []
    for i in range(0, codes.shape[-1], block):
        chunk, state = tm.decode_step(torch.from_numpy(
            codes[:, :, i:i + block].copy()), state)
        assert chunk.shape[-1] == block * TINY.frame_size
        out.append(chunk.numpy())
    return np.concatenate(out, axis=-1), state


@pytest.mark.parametrize("b,f,block", [
    (1, 6, 1),
    (2, 8, 4),   # blocks of F = 4 frames, ring slack sized for them
    (1, 3 * (TINY.sliding_window + 8) + 2, 1),  # 3 x the ring + 2: eviction
])
def test_decode_step_equals_jax_and_batch(mimis, b, f, block):
    jm, tm = mimis
    codes = _codes(b, f, seed=f + block)
    want, _ = _jax_stream(jm, codes, block)
    got, state = _port_stream(tm, codes, block)
    assert got.shape == want.shape == (b, 1, f * TINY.frame_size)
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
    batch = tm.decode(torch.from_numpy(codes)).numpy()
    np.testing.assert_allclose(got, batch, rtol=1e-4, atol=1e-5)
    assert int(state.transformer.index) == f * tm.cfg.downsample_stride


def test_block_past_the_ring_slack_raises(mimis):
    _, tm = mimis
    state = tm.init_decode_state(batch=1, chunk_frames=1)  # slack 8 tokens
    with pytest.raises(ValueError, match="ring slack"):
        tm.decode_step(torch.from_numpy(_codes(1, 5, 1)), state)


def test_reset_decode_row_equals_jax_and_a_fresh_stream(mimis):
    """Row 1 of a 2-row stream recycled after 5 frames: the chunks that
    follow equal JAX's on the same recycled state, and row 1's equal a
    fresh one-row stream of its new codes (up to the rotary phase)."""
    jm, tm = mimis
    first, after = _codes(2, 5, 21), _codes(2, 4, 22)
    _, jstate = _jax_stream(jm, first)
    _, tstate = _port_stream(tm, first)
    jstate = jreset_row(jstate, 1)
    assert reset_decode_row(tstate, 1) is tstate
    assert int(tstate.transformer.start[1]) == int(tstate.transformer.index)
    want, _ = _jax_stream(jm, after, state=jstate)
    got, _ = _port_stream(tm, after, state=tstate)
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
    fresh, _ = _port_stream(tm, after[1:2])
    np.testing.assert_allclose(got[1:2], fresh, atol=1e-4, rtol=0)


def test_stateful_decode_step_and_reset_state(mimis):
    """With no state given, decode_step streams on an internal state;
    reset_state starts a new utterance."""
    _, tm = mimis
    codes = _codes(1, 4, 31)
    tm.reset_state()
    chunks = [tm.decode_step(torch.from_numpy(codes[:, :, i:i + 1].copy()))
              for i in range(4)]
    stream = torch.cat(chunks, dim=-1).numpy()
    want, _ = _port_stream(tm, codes)
    np.testing.assert_array_equal(stream, want)
    tm.reset_state()
    again = tm.decode_step(torch.from_numpy(codes[:, :, :1].copy()))
    np.testing.assert_array_equal(again.numpy(), chunks[0].numpy())
    tm.reset_state()


@pytest.mark.parametrize("stride,t", [(1, 5), (2, 4)])
def test_streamed_convs_equal_jax(stride, t):
    """The conv and transposed-conv stream states, chunk by chunk, against
    JAX's on the same weights and inputs."""
    from csm_mlx_tpu.models.mimi import conv as jconv

    rng = np.random.RandomState(stride)
    w = rng.randn(6, 4, 4).astype(np.float32)
    wt = rng.randn(4, 6, 2 * stride).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    xs = [rng.randn(2, 4, t).astype(np.float32) for _ in range(3)]
    js = jconv.make_conv_state(4, 4, stride, 1, 2)
    jts = jconv.make_convtr_state(6, 2 * stride, stride, 2)
    ts = make_conv_state(4, 4, stride, 1, 2)
    tts = make_convtr_state(6, 2 * stride, stride, 2)
    for x in xs:
        jy, js = jconv.causal_conv1d_streaming(
            {"weight": jnp.asarray(w), "bias": jnp.asarray(bias)},
            jnp.asarray(x), js, stride=stride)
        ty, ts = causal_conv1d_streaming(
            {"weight": torch.from_numpy(w), "bias": torch.from_numpy(bias)},
            torch.from_numpy(x), ts, stride=stride)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
        jz, jts = jconv.causal_conv_transpose1d_streaming(
            {"weight": jnp.asarray(wt), "bias": jnp.asarray(bias)},
            jnp.asarray(x), jts, stride=stride)
        tz, tts = causal_conv_transpose1d_streaming(
            {"weight": torch.from_numpy(wt), "bias": torch.from_numpy(bias)},
            torch.from_numpy(x), tts, stride=stride)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_allclose(ts.prev.numpy(), np.asarray(js.prev),
                               atol=1e-6)
    with pytest.raises(ValueError, match="multiple of stride"):
        causal_conv1d_streaming({"weight": torch.from_numpy(w)},
                                torch.zeros(2, 4, 3), ts, stride=2)


def test_decode_state_lives_on_the_codec_device(mimis):
    _, tm = mimis
    st = tm.init_decode_state(batch=3, chunk_frames=2)
    tensors = [st.transformer.k, st.transformer.index, st.upsample.partial,
               *[getattr(s, f.name) for s in st.seanet
                 for f in dataclasses.fields(s)]]
    assert all(t.device == tm.device for t in tensors)
    assert st.transformer.window == TINY.sliding_window + 8
    assert tuple(st.transformer.start.shape) == (3,)

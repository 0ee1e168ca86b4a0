"""PyTorch port vs JAX package: the frame-level and streaming entry points
on the tiny config — `generate_frame` threaded through `FrameState`
(unquantized and W8A8), `stream_generate` at T = 0 against JAX's and
against the port's `generate`, `generate_tokens` with a filtering sampler
and a repetition penalty, and the port's `FrameStep` against
`_generate_padded`. Greedy tokens must be equal; audio chunks hold to
rtol 1e-4 / atol 1e-5, as `tests/test_integration.py` holds streamed
audio to the batch decode (fp32 on both sides, sums in other orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csm_mlx_tpu.tokenizers as jtok
from conftest import tiny_args
from test_mimi import TINY as TINY_MIMI
from torch_helpers import text_prompt, to_torch, torch_model_from_jax
from csm_mlx_tpu import generation as jgen
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu.models.mimi import Mimi as JMimi
from csm_mlx_tpu.ops import quant as jquant
from csm_mlx_tpu.ops import sampling as jsampling
from csm_mlx_tpu.segment import Segment as JSegment
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch import tokenizers as ttok
from csm_mlx_tpu_torch.bridge import mimi_config_from
from csm_mlx_tpu_torch.models.mimi import Mimi as TMimi
from csm_mlx_tpu_torch.ops import sampling as tsampling
from csm_mlx_tpu_torch.segment import Segment as TSegment


@pytest.fixture(scope="module")
def jax_model():
    """A tiny JAX CSM (fp32) with a random audio_head (a zero head would
    make every decoder codebook 0)."""
    jm = jcsm.CSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(31))
    jm.params["audio_head"] = jax.random.normal(
        jax.random.PRNGKey(32), jm.params["audio_head"].shape) * 0.5
    return jm


def _jax_frames(jm, prompt, mask, n):
    """n greedy frames of JAX `generate_frame`, its state threaded."""
    st = jgen.generate_frame(jm, jnp.asarray(prompt[None]),
                             token_mask=jnp.asarray(mask[None]),
                             temperature=0.0, return_state=True)
    out = [np.asarray(st.frame)]
    for _ in range(n - 1):
        tok, msk = jgen._frame_to_next_input(st.frame)
        st = jgen.generate_frame(jm, tok, token_mask=msk, temperature=0.0,
                                 cache=st.cache, key=st.key,
                                 history=st.history, return_state=True)
        out.append(np.asarray(st.frame))
    return np.stack(out)


def _port_frames(tm, prompt, mask, n):
    st = tgen.generate_frame(tm, torch.from_numpy(prompt[None]),
                             token_mask=torch.from_numpy(mask[None]),
                             temperature=0.0, return_state=True)
    out = [st.frame.numpy()]
    for _ in range(n - 1):
        tok, msk = tgen._frame_to_next_input(st.frame)
        st = tgen.generate_frame(tm, tok, token_mask=msk, temperature=0.0,
                                 cache=st.cache, generator=st.generator,
                                 history=st.history, return_state=True)
        out.append(st.frame.numpy())
    return np.stack(out), st


@pytest.mark.parametrize("quantized,n", [(False, 3), (True, 2)])
def test_generate_frame_threaded_equals_jax(jax_model, quantized, n):
    """A prefill and n - 1 backbone steps, each frame equal to JAX's."""
    jm = jax_model
    if quantized:
        jm = jcsm.CSM(jm.args, params=jax.tree_util.tree_map(
            lambda a: a, jm.params), dtype=jnp.float32)
        jquant.quantize_model(jm, mode="w8a8", min_size=1)
    tm = torch_model_from_jax(jm)
    prompt, mask = text_prompt(jm.args, 6, seed=4)
    want = _jax_frames(jm, prompt, mask, n)
    got, st = _port_frames(tm, prompt, mask, n)
    np.testing.assert_array_equal(got, want)
    cap = jm.args.backbone_config.max_position_embeddings
    assert st.cache.capacity == cap and st.cache.length == 6 + n - 1
    assert int(st.cache.index) == 6 + n - 1


def test_generate_frame_state_contract(jax_model):
    tm = torch_model_from_jax(jax_model)
    prompt, mask = text_prompt(tm.args, 3, seed=1)
    st = tgen.generate_frame(tm, prompt[None], token_mask=mask[None],
                             temperature=0.0, return_state=True)
    assert isinstance(st, tgen.FrameState) and st.frame.shape == (1, 8)
    for kw in (dict(cache=st.cache), dict(history=st.history),
               dict(generator=torch.Generator())):
        with pytest.raises(ValueError, match="return_state"):
            tgen.generate_frame(tm, prompt[None], temperature=0.0, **kw)
    frame = tgen.generate_frame(tm, prompt[None], token_mask=mask[None],
                                temperature=0.0)
    torch.testing.assert_close(frame, st.frame, rtol=0, atol=0)


def test_stream_generate_equals_jax_and_generate(jax_model, monkeypatch):
    jm = jax_model
    tm = torch_model_from_jax(jm)
    mcfg = dataclasses.replace(TINY_MIMI,
                               num_quantizers=jm.args.n_audio_codebooks)
    jmimi = JMimi(mcfg, rng=jax.random.PRNGKey(33))
    tmimi = TMimi(mimi_config_from(mcfg), params=to_torch(jmimi.params))
    prompt, mask = text_prompt(jm.args, 7, seed=6)
    jassemble = jgen._assemble_prompt
    monkeypatch.setattr(jgen, "_assemble_prompt",
                        lambda *a: (prompt, mask))
    monkeypatch.setattr(jtok, "get_audio_tokenizer", lambda *a: jmimi)
    monkeypatch.setattr(ttok, "tokenize_text_segment",
                        lambda *a: (prompt, mask))
    jgen._build_stream_fns.cache_clear()
    try:
        want = [np.asarray(c) for c in jgen.stream_generate(
            jm, "hi", 0, max_audio_length_ms=480, temperature=0.0,
            key=jax.random.PRNGKey(0))]
    finally:
        jgen._build_stream_fns.cache_clear()
    got = list(tgen.stream_generate(tm, "hi", 0, max_audio_length_ms=480,
                                    temperature=0.0, mimi=tmimi))
    assert len(got) == len(want) == 6
    assert all(c.shape == (mcfg.frame_size,) and c.device.type == "cpu"
               for c in got)
    np.testing.assert_allclose(np.stack([c.numpy() for c in got]),
                               np.stack(want), rtol=1e-4, atol=1e-5)
    wav = tgen.generate(tm, "hi", 0, max_audio_length_ms=480,
                        temperature=0.0, mimi=tmimi)
    np.testing.assert_allclose(torch.cat(got).numpy(), wav.numpy(),
                               rtol=1e-4, atol=1e-5)
    # with a context segment: its rows (the stand-in prompt, the codes of
    # its audio and the EOS frame) go before the text's, in both packages
    monkeypatch.setattr(jgen, "_assemble_prompt", jassemble)
    monkeypatch.setattr(jtok, "tokenize_text_segment",
                        lambda *a: (prompt, mask))
    audio = (0.3 * np.sin(np.arange(3 * mcfg.frame_size) * 0.07)).astype(
        np.float32)
    jgen._build_stream_fns.cache_clear()
    try:
        want = [np.asarray(c) for c in jgen.stream_generate(
            jm, "hi", 0, [JSegment(1, "ctx", audio)],
            max_audio_length_ms=480, temperature=0.0,
            key=jax.random.PRNGKey(0))]
    finally:
        jgen._build_stream_fns.cache_clear()
    got = list(tgen.stream_generate(tm, "hi", 0, [TSegment(1, "ctx", audio)],
                                    max_audio_length_ms=480, temperature=0.0,
                                    mimi=tmimi))
    assert len(got) == len(want) >= 1
    np.testing.assert_allclose(np.stack([c.numpy() for c in got]),
                               np.stack(want), rtol=1e-4, atol=1e-5)


def test_generate_tokens_with_filters_and_penalty_equals_jax(jax_model):
    """At T = 0 the filters leave the argmax alone and the repetition
    penalty changes c0's logits: frames equal JAX's, frame for frame."""
    jm = jax_model
    tm = torch_model_from_jax(jm)
    prompt, mask = text_prompt(jm.args, 5, seed=8)
    kw = dict(repetition_penalty=3.0, repetition_context_size=4,
              logit_bias={1: 0.75})
    want, n_want = jgen.generate_tokens(
        jm, prompt, mask, 6,
        sampler=jsampling.make_sampler(0.0, top_p=0.8, min_p=0.1, top_k=4),
        logits_processors=jsampling.make_logits_processors(**kw))
    got, n_got = tgen.generate_tokens(
        tm, prompt, mask, 6,
        sampler=tsampling.make_sampler(0.0, top_p=0.8, min_p=0.1, top_k=4),
        logits_processors=tsampling.make_logits_processors(**kw))
    plain, _ = tgen.generate_tokens(tm, prompt, mask, 6, temperature=0.0)
    assert n_got == n_want and n_got >= 2
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[:n_got, 0], plain[:n_got, 0])


def test_frame_step_equals_generate_padded(jax_model):
    """The step driven by hand — prefill, first frame, then one call a
    frame — makes `_generate_padded`'s frames; the cache overflow raises on
    the host's count."""
    tm = torch_model_from_jax(jax_model)
    prompts = [text_prompt(tm.args, s, seed=s) for s in (4, 9)]
    want, n = tgen.generate_tokens_batch(tm, [p for p, _ in prompts],
                                         [m for _, m in prompts], 5,
                                         temperature=0.0)
    bucket = tgen.prompt_bucket(9)
    tokens = np.zeros((2, bucket, 9), np.int32)
    masks = np.zeros_like(tokens)
    pads = np.zeros((2,), np.int32)
    for i, (p, m) in enumerate(prompts):
        pads[i] = bucket - p.shape[0]
        tokens[i, pads[i]:], masks[i, pads[i]:] = p, m
    step = tgen.FrameStep(tm, 2, bucket + 5,
                          tsampling.SamplerConfig(temperature=0.0), (), None)
    assert not step.capture  # CPU tensors: eager
    step.first(step.prefill(tokens, masks, pads))
    got = [step.frame.clone()]
    for _ in range(4):
        step()
        got.append(step.frame.clone())
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)
    assert int(n.min()) == 5 and step.cache.length == bucket + 4
    step()
    with pytest.raises(ValueError, match="overflow"):
        step()


def test_interleaved_streams_equal_their_solo_runs(jax_model, monkeypatch):
    """Two `stream_generate` iterators with the same settings, consumed in
    turn, each yield their own solo run's chunks (each call holds its own
    frame step); a stream closed early leaves the next one unchanged."""
    tm = torch_model_from_jax(jax_model)
    mcfg = dataclasses.replace(TINY_MIMI,
                               num_quantizers=tm.args.n_audio_codebooks)
    tmimi = TMimi(mimi_config_from(mcfg), params=to_torch(
        JMimi(mcfg, rng=jax.random.PRNGKey(34)).params))
    prompts = {"a": text_prompt(tm.args, 5, seed=11),
               "b": text_prompt(tm.args, 9, seed=12)}
    monkeypatch.setattr(ttok, "tokenize_text_segment",
                        lambda text, *a: prompts[text])

    def stream(text):
        return tgen.stream_generate(tm, text, 0, max_audio_length_ms=400,
                                    temperature=0.0, mimi=tmimi)

    solo = {t: torch.stack(list(stream(t))) for t in prompts}
    assert solo["a"].shape == solo["b"].shape == (5, mcfg.frame_size)
    assert not torch.equal(solo["a"], solo["b"])
    got = {t: [] for t in prompts}
    its = {t: stream(t) for t in prompts}
    for _ in range(5):
        for t, it in its.items():
            got[t].append(next(it))
    for t in prompts:
        assert next(its[t], None) is None
        torch.testing.assert_close(torch.stack(got[t]), solo[t], rtol=0,
                                   atol=0)
    early = stream("b")
    next(early)
    early.close()
    torch.testing.assert_close(torch.stack(list(stream("a"))), solo["a"],
                               rtol=0, atol=0)


def test_held_step_is_one_callers_at_a_time():
    """`_held`: a step is out of the model's dict while a call holds it (a
    second call builds its own), back as the most recently used after it,
    also when a generator holding it is closed; dropped when its caller
    raised; at most `_STEPS_PER_MODEL` kept."""
    steps, built = {}, []

    def build():
        built.append(object())
        return built[-1]

    with tgen._held(steps, "k", build) as a:
        assert "k" not in steps
        with tgen._held(steps, "k", build) as b:
            assert b is not a
        assert steps["k"] is b
    assert steps["k"] is a and len(built) == 2
    with tgen._held(steps, "k", build) as c:
        assert c is a

    def holder():
        with tgen._held(steps, "k", build) as s:
            yield s
            yield s

    it = holder()
    s = next(it)
    assert s is a and "k" not in steps
    it.close()
    assert steps["k"] is a
    with pytest.raises(RuntimeError):
        with tgen._held(steps, "k", build):
            raise RuntimeError("the caller failed")
    assert "k" not in steps
    for key in range(tgen._STEPS_PER_MODEL + 2):
        with tgen._held(steps, key, build):
            pass
    assert list(steps) == list(range(2, tgen._STEPS_PER_MODEL + 2))

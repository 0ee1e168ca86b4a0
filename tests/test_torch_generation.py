"""PyTorch port vs JAX package: the greedy text-to-speech slice (tiny
configs) — frames, EOS, the context-window guard, W8A8 teacher-forced
logits — and the Mimi decode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_args
from test_mimi import TINY as TINY_MIMI
from torch_helpers import text_prompt, to_torch, torch_model_from_jax
from csm_mlx_tpu import generation as jgen
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu.models.llama import llama_forward as jfwd
from csm_mlx_tpu.models.mimi import Mimi as JMimi
from csm_mlx_tpu.ops import quant as jquant
from csm_mlx_tpu.ops.attention import causal_mask_bias as jcausal
from csm_mlx_tpu.ops.kv_cache import KVCache as JKVCache
from csm_mlx_tpu.ops.layers import linear as jlinear
from csm_mlx_tpu.ops.rope import rope_cache_for as jrope_cache
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch.bridge import mimi_config_from
from csm_mlx_tpu_torch.models import csm as tcsm
from csm_mlx_tpu_torch.models.llama import llama_forward as tfwd
from csm_mlx_tpu_torch.models.mimi import Mimi as TMimi
from csm_mlx_tpu_torch.models.mimi.mimi import mimi_decode_fn as tmimi_decode
from csm_mlx_tpu_torch.ops import quant as tquant
from csm_mlx_tpu_torch.ops.attention import causal_mask_bias as tcausal
from csm_mlx_tpu_torch.ops.kv_cache import KVCache as TKVCache
from csm_mlx_tpu_torch.ops.layers import linear as tlinear
from csm_mlx_tpu_torch.ops.rope import rope_cache_for as trope_cache
from csm_mlx_tpu_torch.segment import Segment


@pytest.fixture(scope="module")
def base_params():
    """Params of a tiny JAX CSM (fp32) with a random audio_head: a zero
    head would make every decoder codebook 0."""
    params = jcsm.CSM(tiny_args(), dtype=jnp.float32,
                      rng=jax.random.PRNGKey(11)).params
    params["audio_head"] = jax.random.normal(
        jax.random.PRNGKey(12), params["audio_head"].shape) * 0.5
    return params


def _jax_model(params):
    """A JAX CSM over a copy of the param tree (quantize_model edits the
    tree in place)."""
    return jcsm.CSM(tiny_args(), params=jax.tree_util.tree_map(
        lambda a: a, params), dtype=jnp.float32)


@pytest.mark.parametrize("s", [5, 40])  # buckets 32 and 64, pads 27 and 24
def test_greedy_frames_equal_jax(base_params, s):
    jm = _jax_model(base_params)
    tm = torch_model_from_jax(jm)
    prompt, mask = text_prompt(jm.args, s, seed=s)
    want, n_want = jgen.generate_tokens(jm, prompt, mask, 4, temperature=0.0)
    got, n_got = tgen.generate_tokens(tm, prompt, mask, 4, temperature=0.0)
    assert n_got == n_want == 4
    np.testing.assert_array_equal(got, want)


def test_context_window_guard(base_params):
    tm = torch_model_from_jax(_jax_model(base_params))
    prompt, mask = text_prompt(tm.args, 500)
    with pytest.raises(ValueError, match="Inputs too long"):
        tgen.generate_tokens(tm, prompt, mask, 100)


def test_per_row_eos_matches_jax(base_params):
    """A zero audio_head makes codebooks 1..31 zero, and a codebook0_head
    of rows (a, -a, 0, ...) makes c0 == 0 exactly when a.h > 0: each row
    then ends on its own all-zero frame. Rows must stop where JAX's do."""
    jm = _jax_model(base_params)
    jm.params["audio_head"] = jnp.zeros_like(jm.params["audio_head"])
    a = np.random.RandomState(4).randn(jm.args.backbone_dim).astype(
        np.float32)
    head = np.zeros((jm.args.n_audio_vocab, jm.args.backbone_dim),
                    np.float32)
    head[0], head[1] = a, -a
    jm.params["codebook0_head"]["weight"] = jnp.asarray(head)
    tm = torch_model_from_jax(jm)
    prompts, masks = zip(*[text_prompt(jm.args, s, seed=s)
                           for s in (3, 9, 17, 30, 6, 12)])
    want, n_want = jgen.generate_tokens_batch(jm, prompts, masks, 8,
                                              temperature=0.0)
    got, n_got = tgen.generate_tokens_batch(tm, prompts, masks, 8,
                                            temperature=0.0)
    np.testing.assert_array_equal(n_got, n_want)
    assert len(set(n_want.tolist())) > 2  # rows really stop apart
    for row, n in enumerate(n_want):
        np.testing.assert_array_equal(got[:n, row], want[:n, row])


_jfwd_jit = jax.jit(jfwd, static_argnums=(1,))
_jstep_jit = jax.jit(jgen._backbone_step, static_argnums=(1,))


def _jax_teacher_logits(model, prompt, mask, frames):
    """c0 and decoder logits of every frame, fed the given frames."""
    args, params = model.args, model.params
    tokens, msk, pad, bucket = jgen._pad_prompt(prompt, mask)
    bcfg, dcfg = args.backbone_config, args.decoder_config
    cap_b, cap_d = bucket + len(frames), args.n_audio_codebooks + 1
    cos_b, sin_b = jrope_cache(bcfg, max(cap_b, bcfg.max_position_embeddings))
    cos_d, sin_d = jrope_cache(dcfg, cap_d)
    cache = JKVCache.init(bcfg, 1, cap_b, dtype=jnp.float32)
    h, cache = jgen._prefill(params, args, jnp.asarray(tokens),
                             jnp.asarray(msk), jnp.asarray(pad), cache,
                             cos_b, sin_b)
    out = []
    for f, frame in enumerate(frames):
        fr = jnp.asarray(frame[None], jnp.int32)
        logits = [jlinear(params["codebook0_head"], h)[0]]
        x = jlinear(params["projection"], jnp.stack(
            [h, jcsm.embed_audio(params, args, 0, fr[:, 0])], axis=1))
        dc = JKVCache.init(dcfg, 1, cap_d, dtype=jnp.float32)
        pos, q_off = jnp.arange(2)[None], 0
        for i in range(1, args.n_audio_codebooks):
            hd, dc = _jfwd_jit(params["decoder"], dcfg, x, cos_d, sin_d, pos,
                          jcausal(x.shape[1], cap_d, q_off)[None, None], dc)
            logits.append(jquant.audio_head_logits(
                params["audio_head"], i - 1, hd[:, -1], args.n_audio_vocab)[0])
            emb = jcsm.embed_audio(params, args, i, fr[:, i])
            x = jlinear(params["projection"], emb[:, None, :])
            pos, q_off = dc.index.reshape(1, 1), dc.index
        out.append(np.stack([np.asarray(l) for l in logits]))
        if f + 1 < len(frames):
            t, m = jgen._frame_to_next_input(fr)
            h, cache = _jstep_jit(params, args, t, m,
                                           jnp.asarray(pad), cache, cos_b,
                                           sin_b)
    return np.stack(out)  # (F, 32, V)


@torch.no_grad()
def _torch_teacher_logits(model, prompt, mask, frames):
    args, params = model.args, model.params
    tokens, msk, pad, bucket = tgen._pad_prompt(prompt, mask)
    bcfg, dcfg = args.backbone_config, args.decoder_config
    cap_b, cap_d = bucket + len(frames), args.n_audio_codebooks + 1
    cos_b, sin_b = trope_cache(bcfg, max(cap_b, bcfg.max_position_embeddings),
                               "cpu")
    cos_d, sin_d = trope_cache(dcfg, cap_d, "cpu")
    pad = torch.from_numpy(pad).long()
    cache = TKVCache.init(bcfg, 1, cap_b, dtype=torch.float32, device="cpu")
    h, cache = tgen._prefill(params, args, torch.from_numpy(tokens).long(),
                             torch.from_numpy(msk).long(), pad, cache, cos_b,
                             sin_b)
    out = []
    for f, frame in enumerate(frames):
        fr = torch.from_numpy(frame[None].copy()).long()
        logits = [tlinear(params["codebook0_head"], h)[0]]
        x = tlinear(params["projection"], torch.stack(
            [h, tcsm.embed_audio(params, args, 0, fr[:, 0])], dim=1))
        dc = TKVCache.init(dcfg, 1, cap_d, dtype=torch.float32,
                            device="cpu")
        pos, q_off = torch.arange(2)[None], 0
        for i in range(1, args.n_audio_codebooks):
            hd, dc = tfwd(params["decoder"], dcfg, x, cos_d, sin_d, pos,
                          tcausal(x.shape[1], cap_d, q_off)[None, None], dc)
            logits.append(tquant.audio_head_logits(
                params["audio_head"], i - 1, hd[:, -1], args.n_audio_vocab)[0])
            emb = tcsm.embed_audio(params, args, i, fr[:, i])
            x = tlinear(params["projection"], emb[:, None, :])
            pos, q_off = torch.full((1, 1), dc.index), dc.index
        out.append(torch.stack(logits).numpy())
        if f + 1 < len(frames):
            t, m = tgen._frame_to_next_input(fr)
            h, cache = tgen._backbone_step(params, args, t, m, pad, cache,
                                           cos_b, sin_b)
    return np.stack(out)


def test_w8a8_teacher_forced_logits_match_jax(base_params):
    """W8A8 (min_size=0, fused) on both sides, fed JAX's greedy frames:
    the c0 and decoder logits agree to 1e-3 and their argmaxes on >= 99%
    of the codebooks. Quantized paths are held to flip rates, not to
    exact tokens."""
    jm = _jax_model(base_params)
    tm = torch_model_from_jax(jm)
    jquant.quantize_model(jm, mode="w8a8", min_size=0)
    tquant.quantize_model(tm, mode="w8a8", min_size=0)
    prompt, mask = text_prompt(jm.args, 12, seed=2)
    frames, n = jgen.generate_tokens(jm, prompt, mask, 3, temperature=0.0)
    assert n == 3
    want = _jax_teacher_logits(jm, prompt, mask, frames)
    got = _torch_teacher_logits(tm, prompt, mask, frames)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.99, agree
    # the JAX greedy frames are the argmaxes of its own teacher-forced logits
    np.testing.assert_array_equal(want.argmax(-1), frames)


def test_mimi_decode_matches_jax():
    jm = JMimi(TINY_MIMI, rng=jax.random.PRNGKey(7))
    tm = TMimi(mimi_config_from(TINY_MIMI), params=to_torch(jm.params))
    # codes past the codebook (CSM's vocabulary is wider) clamp, as in JAX
    codes = np.random.RandomState(5).randint(
        0, TINY_MIMI.codebook_size + 3, size=(2, TINY_MIMI.num_quantizers, 7))
    # the JAX class runs mimi_decode_fn jitted over codes padded to a frame
    # bucket; the port decodes the 7 frames as they are
    want = np.asarray(jm.decode(jnp.asarray(codes)))
    got = tmimi_decode(tm.params, tm.cfg, torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (2, 1, 7 * TINY_MIMI.frame_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tm.decode(torch.from_numpy(codes)).numpy(),
                                  got)


def _word_tokenizer(directory) -> str:
    """A local WordLevel `tokenizer.json` with Llama's BOS/EOS names."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"<|begin_of_text|>": 0, "<|end_of_text|>": 1, "[": 2, "0": 3,
             "]": 4, "hello": 5, "world": 6, "[UNK]": 7, "hi": 8}
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(directory / "tokenizer.json"))
    return str(directory)


@pytest.fixture
def fresh_tokenizers(monkeypatch):
    """The port's tokenizer and codec singletons empty, and neither path
    variable set, before and after the test."""
    from csm_mlx_tpu_torch import tokenizers as ttok

    monkeypatch.delenv(ttok.TEXT_TOKENIZER_ENV, raising=False)
    monkeypatch.delenv(ttok.MIMI_WEIGHTS_ENV, raising=False)
    ttok.get_text_tokenizer.cache_clear()
    ttok.get_audio_tokenizer.cache_clear()
    yield ttok
    ttok.get_text_tokenizer.cache_clear()
    ttok.get_audio_tokenizer.cache_clear()


def test_generate_text_to_waveform(base_params, tmp_path, fresh_tokenizers):
    """`generate` = the canonical local-path text tokenizer (BOS/EOS
    template, text in column 32) + `generate_tokens` + Mimi decode."""
    ttok = fresh_tokenizers
    ttok.get_text_tokenizer(_word_tokenizer(tmp_path))  # installs it
    prompt, mask = ttok.tokenize_text_segment("hello world", 0, 8)
    np.testing.assert_array_equal(prompt[:, -1], [0, 2, 3, 4, 5, 6, 1])
    assert not prompt[:, :-1].any() and (mask[:, -1] == 1).all()

    tm = torch_model_from_jax(_jax_model(base_params))
    cfg = mimi_config_from(dataclasses.replace(TINY_MIMI, num_quantizers=8))
    mimi = TMimi(cfg, generator=torch.Generator().manual_seed(3),
                 device="cpu")
    wav = tgen.generate(tm, "hello world", 0, max_audio_length_ms=320,
                        mimi=mimi, temperature=0.0)
    frames, n = tgen.generate_tokens(tm, prompt, mask, 4, temperature=0.0)
    want = mimi.decode(torch.from_numpy(frames.T[None].copy()))[0, 0]
    assert wav.shape == (n * cfg.frame_size,) and n == 4
    torch.testing.assert_close(wav, want, rtol=0, atol=0)


def test_text_tokenizer_singleton_in_jax_argument_order(tmp_path,
                                                        monkeypatch,
                                                        fresh_tokenizers):
    """JAX's contract: `tokenize_text_segment(text, speaker,
    n_audio_codebooks)` positionally, the tokenizer from
    `CSM_TPU_TEXT_TOKENIZER` read once and cached; a given path that does
    not exist raises, and so does a call with no path at all."""
    ttok = fresh_tokenizers
    with pytest.raises(FileNotFoundError, match=ttok.TEXT_TOKENIZER_ENV):
        ttok.tokenize_text_segment("hi", 0, 32)
    with pytest.raises(FileNotFoundError):
        ttok.get_text_tokenizer(str(tmp_path / "missing"))
    monkeypatch.setenv(ttok.TEXT_TOKENIZER_ENV, _word_tokenizer(tmp_path))
    frame, mask = ttok.tokenize_text_segment("hi", 0, 32)
    assert frame.shape == mask.shape == (6, 33)
    np.testing.assert_array_equal(frame[:, 32], [0, 2, 3, 4, 8, 1])
    assert not frame[:, :32].any() and mask[:, 32].all()
    first = ttok.get_text_tokenizer()
    (tmp_path / "tokenizer.json").unlink()  # never read again
    assert ttok.get_text_tokenizer() is first
    assert ttok.tokenize_text_segment("hi", 0, 8)[0].shape == (6, 9)


def test_generate_in_jax_argument_order(base_params, tmp_path, monkeypatch,
                                        fresh_tokenizers):
    """`generate(model, text, speaker, context, max_audio_length_ms,
    mimi=...)` as JAX calls it, with the codec from the
    `get_audio_tokenizer` singleton when none is given: one random-init
    codec per codebook count and device. Context audio is encoded into the
    prompt: the frames are `generate_tokens`' on `_assemble_prompt`'s rows.
    A given weights path that is missing raises FileNotFoundError, one the
    loader cannot read its ValueError."""
    ttok = fresh_tokenizers
    monkeypatch.setenv(ttok.TEXT_TOKENIZER_ENV, _word_tokenizer(tmp_path))
    tm = torch_model_from_jax(_jax_model(base_params))
    codec = ttok.get_audio_tokenizer(tm.n_audio_codebooks, device="cpu")
    assert ttok.get_audio_tokenizer(tm.n_audio_codebooks,
                                    device="cpu") is codec
    assert codec.cfg.num_quantizers == tm.n_audio_codebooks

    wav = tgen.generate(tm, "hello world", 0, (), 800, mimi=codec,
                        temperature=0)
    default = tgen.generate(tm, "hello world", 0, (), 800, temperature=0)
    prompt, mask = ttok.tokenize_text_segment("hello world", 0,
                                              tm.n_audio_codebooks)
    frames, n = tgen.generate_tokens(tm, prompt, mask, 10, temperature=0.0)
    want = codec.decode(torch.from_numpy(frames.T[None].copy()))[0, 0]
    assert n >= 1 and wav.shape == (n * codec.frame_size,)
    torch.testing.assert_close(wav, want, rtol=0, atol=0)
    torch.testing.assert_close(default, wav, rtol=0, atol=0)

    # context audio, through a codec whose codes lie in the tiny model's
    # audio vocabulary (the singleton's 2048 entries do not)
    small = TMimi(mimi_config_from(dataclasses.replace(TINY_MIMI,
                                                       num_quantizers=8)),
                  generator=torch.Generator().manual_seed(5), device="cpu")
    ctx = [Segment(1, "before", np.sin(np.arange(2 * small.frame_size)
                                       * 0.5).astype(np.float32) * 0.3)]
    wav = tgen.generate(tm, "hello world", 0, ctx, 800, mimi=small,
                        temperature=0)
    prompt, mask = tgen._assemble_prompt(tm, "hello world", 0, ctx, small)
    t = ttok.tokenize_text_segment("before", 1, 8)[0].shape[0]
    assert prompt.shape[0] == t + 3 + 7  # text, 2 frames + EOS, text
    assert prompt[t:t + 2, :-1].any() and not prompt[t + 2].any()
    frames, n = tgen.generate_tokens(tm, prompt, mask, 10, temperature=0.0)
    want = small.decode(torch.from_numpy(frames.T[None].copy()))[0, 0]
    assert n >= 1 and wav.shape == (n * small.frame_size,)
    torch.testing.assert_close(wav, want, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        ttok.get_audio_tokenizer(8, str(tmp_path / "missing.safetensors"))
    weights = tmp_path / "mimi.safetensors"
    weights.write_bytes(b"")
    monkeypatch.setenv(ttok.MIMI_WEIGHTS_ENV, str(weights))
    with pytest.raises(ValueError, match="safetensors"):
        ttok.get_audio_tokenizer(8, device="cpu")

"""PyTorch port vs JAX package: W4A8 (`quantize_model(mode="w4a8")`) and the
int8 audio head (`quantize_audio_head`, `audio_head_logits`' dict branch)
on the tiny config.

The JAX package stores W4A8 codes as `jnp.int4` on the CPU and then runs
its dequant einsum; a TPU keeps them in int8 carriers and runs the W8A8
arithmetic (`_xla_w8a8_matvec`, the Pallas kernel). The port stores int8
carriers always, so it is held to the TPU's arithmetic: the JAX leaves are
widened to int8 here, in the test, before JAX computes with them. Nothing
in the JAX package changes for that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_args
from test_torch_generation import _jax_teacher_logits, _torch_teacher_logits
from torch_helpers import text_prompt, to_torch, torch_model_from_jax
from csm_mlx_tpu import generation as jgen
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu.ops import quant as jquant
from csm_mlx_tpu.ops import resident_decoder as jres
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch.continuous import ContinuousEngine
from csm_mlx_tpu_torch.ops import quant as tquant
from csm_mlx_tpu_torch.ops import resident_decoder as tres

# as tests/test_torch_quant.py: the int32 products are exact on both sides
RTOL = 1e-5


def _widened(tree):
    """JAX's W4A8 CPU leaves (int4) in int8 carriers, as a TPU holds them."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.int8) if a.dtype == jnp.int4 else a, tree)


@pytest.fixture(scope="module")
def base_params():
    """Params of a tiny JAX CSM (fp32) with a random audio_head."""
    params = jcsm.CSM(tiny_args(), dtype=jnp.float32,
                      rng=jax.random.PRNGKey(31)).params
    params["audio_head"] = jax.random.normal(
        jax.random.PRNGKey(32), params["audio_head"].shape) * 0.5
    return params


def _jax_model(params):
    return jcsm.CSM(tiny_args(), params=jax.tree_util.tree_map(
        lambda a: a, params), dtype=jnp.float32)


def test_quantize_weight_w4_codes_equal_jax():
    """Codes in [-7, 7] in int8, scales and biases equal to the bit to the
    JAX quantizer as `quantize_model` runs it (jitted), the codes equal to
    its int4 codes widened."""
    rng = np.random.RandomState(40)
    w = (rng.randn(192, 320) * 0.1).astype(np.float32)
    w[7] = -0.5  # a constant row: the scale clamps to 1e-12
    want = jax.device_get(
        jquant._jitted_quantizer("w4a8", 4, 64)(jnp.asarray(w)))
    assert want["weight_q"].dtype == jnp.int4
    got = tquant.quantize_weight_w8(torch.from_numpy(w), bits=4)
    assert got["weight_q"].dtype == torch.int8
    assert int(got["weight_q"].abs().max()) == 7
    np.testing.assert_array_equal(got["weight_q"].numpy(),
                                  np.asarray(want["weight_q"]).astype(np.int8))
    for k in ("scales", "biases"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(ValueError, match="bits 2"):
        tquant.quantize_weight_w8(torch.from_numpy(w), bits=2)


def test_quantize_model_w4a8_leaves_equal_jax(base_params):
    """`quantize_model(mode="w4a8")` (fused) on both sides: the same tree,
    each leaf equal once the bridge has widened JAX's int4 codes to int8."""
    jm = _jax_model(base_params)
    tm = torch_model_from_jax(jm)
    jquant.quantize_model(jm, mode="w4a8", min_size=0)
    tquant.quantize_model(tm, mode="w4a8", min_size=0)
    want = to_torch(jm.params)
    n_codes = 0

    def compare(w, g, path):
        nonlocal n_codes
        if isinstance(w, dict):
            assert set(w) == set(g), path
            for k in w:
                compare(w[k], g[k], f"{path}.{k}")
        elif isinstance(w, list):
            for i, (a, b) in enumerate(zip(w, g)):
                compare(a, b, f"{path}.{i}")
        else:
            assert g.dtype == w.dtype, path
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=path)
            if path.endswith("weight_q"):
                n_codes += 1
                assert g.dtype == torch.int8 and int(g.abs().max()) <= 7

    compare(want, tm.params, "params")
    assert n_codes > 0
    assert "qkv_proj" in tm.params["decoder"]["layers"][0]["self_attn"]
    assert isinstance(tm.params["audio_head"], torch.Tensor)  # not a target


@pytest.mark.parametrize("rows", [1, 8, 64, 65, 300])
def test_w4a8_linear_matches_jax_int8_arithmetic(rows):
    """The port's W4A8 linear against JAX's `_xla_w8a8_matvec` on the codes
    widened to int8 (a TPU's W4A8 arithmetic), and at <= 64 rows against
    the Pallas W8A8 kernel in interpret mode on the same codes."""
    rng = np.random.RandomState(rows)
    w = (rng.randn(256, 256) * 0.1).astype(np.float32)
    x = rng.randn(rows, 256).astype(np.float32)
    jq = _widened(jax.jit(lambda a: jquant.quantize_weight_w8(a, bits=4))(
        jnp.asarray(w)))
    want = np.asarray(jquant._xla_w8a8_matvec(
        jnp.asarray(x), jq["weight_q"], jq["scales"], jq["biases"]))
    tq = tquant.quantize_weight_w8(torch.from_numpy(w), bits=4)
    got = tquant.quant_linear(tq, torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)
    if rows <= 64:
        pallas = np.asarray(jquant._pallas_quant_matvec_w8a8(
            jnp.asarray(x), jq["weight_q"], jq["scales"], jq["biases"],
            bits=8, group_size=256))
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("v", [64, 200])
def test_quantize_audio_head_equals_jax(v):
    """(K-1, V_pad, D) int8 codes and (K-1, V_pad, 1) fp32 scales and
    biases, V padded to a multiple of 128, equal to the bit to JAX's; each
    head a contiguous view on a 16-byte boundary, as kernel 1 takes it."""
    head = (np.random.RandomState(v).randn(7, 32, v) * 0.3).astype(np.float32)
    want = jax.device_get(jquant.quantize_audio_head(jnp.asarray(head)))
    got = tquant.quantize_audio_head(torch.from_numpy(head))
    v_pad = -(-v // 128) * 128
    assert got["weight_q"].shape == (7, v_pad, 32)
    assert got["weight_q"].dtype == torch.int8
    for k in ("scales", "biases"):
        assert got[k].shape == (7, v_pad, 1) and got[k].dtype == torch.float32
    for k in ("weight_q", "scales", "biases"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert got[k].is_contiguous()
        for i in range(7):
            assert got[k][i].is_contiguous()
            assert got[k][i].data_ptr() % 16 == got[k].data_ptr() % 16
    assert not got["weight_q"][:, v:].any()  # the pad's codes are zero


def test_audio_head_logits_dict_branch_equals_jax(base_params):
    """`audio_head_logits` over the quantized head (kernel 1's plain version
    here) against JAX's dict branch (its W8A8 XLA mirror on the CPU), the
    pad sliced off; the raw branch as well."""
    head = base_params["audio_head"]
    v = head.shape[-1]
    jq = jquant.quantize_audio_head(head)
    tq = tquant.quantize_audio_head(to_torch(head))
    hidden = np.random.RandomState(5).randn(3, head.shape[1]).astype(
        np.float32)
    for i in (0, 3, head.shape[0] - 1):
        want = np.asarray(jquant.audio_head_logits(jq, i, jnp.asarray(hidden),
                                                   v))
        got = tquant.audio_head_logits(tq, i, torch.from_numpy(hidden), v)
        assert got.dtype == torch.float32 and got.shape == (3, v)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
        raw = np.asarray(jquant.audio_head_logits(head, i,
                                                  jnp.asarray(hidden), v))
        np.testing.assert_allclose(
            tquant.audio_head_logits(to_torch(head), i,
                                     torch.from_numpy(hidden), v).numpy(),
            raw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode,targets", [
    ("w8a8", ("backbone", "decoder", "projection", "audio_head")),
    ("w4a8", ("backbone", "decoder", "projection")),
    ("w4a8", ("backbone", "decoder", "projection", "audio_head")),
])
def test_teacher_forced_logits_match_jax(base_params, mode, targets):
    """Quantized on both sides (min_size=0, fused), JAX's W4A8 leaves
    widened to int8, fed JAX's greedy frames: the c0 and decoder logits
    agree to 1e-3 and their argmaxes on >= 99% of the codebooks, as the
    W8A8 test of tests/test_torch_generation.py gates."""
    jm = _jax_model(base_params)
    tm = torch_model_from_jax(jm)
    jquant.quantize_model(jm, mode=mode, min_size=0, targets=targets)
    jm.params = _widened(jm.params)
    tquant.quantize_model(tm, mode=mode, min_size=0, targets=targets)
    assert isinstance(tm.params["audio_head"], dict) == \
        ("audio_head" in targets)
    prompt, mask = text_prompt(jm.args, 12, seed=3)
    frames, n = jgen.generate_tokens(jm, prompt, mask, 3, temperature=0.0)
    assert n == 3
    want = _jax_teacher_logits(jm, prompt, mask, frames)
    got = _torch_teacher_logits(tm, prompt, mask, frames)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.99, agree
    np.testing.assert_array_equal(want.argmax(-1), frames)
    got_frames, n_got = tgen.generate_tokens(tm, prompt, mask, 3,
                                             temperature=0.0)
    assert n_got == 3
    assert (got_frames == frames).mean() >= 0.99


@pytest.fixture(scope="module")
def w4a8_models(base_params):
    """JAX W4A8 (fused; decoder and projection) with its leaves widened to
    int8 and kernel 3's tables prepared from them; the port's model
    carried from it, and one that quantizes and prepares its own."""
    jm = _jax_model(base_params)
    jquant.quantize_model(jm, mode="w4a8", min_size=1,
                          targets=("decoder", "projection"))
    jm.params = _widened(jm.params)
    assert jres.prepare_resident_decoder(jm)
    carried = torch_model_from_jax(jm)
    own = torch_model_from_jax(_jax_model(base_params))
    tquant.quantize_model(own, mode="w4a8", min_size=1,
                          targets=("decoder", "projection"))
    assert "_resident" not in own.params  # only a CUDA model prepares
    assert tres.prepare_resident_decoder(own)
    return jm, carried, own


@pytest.mark.parametrize("b", [1, 3])
def test_resident_frame_on_w4a8_tables_equals_jax_kernel(w4a8_models, b):
    """Kernel 3's plain version on W4A8 tables, carried and the port's own,
    against JAX's interpret-mode kernel on the same (widened) tables: equal
    greedy tokens; the tables equal JAX's."""
    jm, carried, own = w4a8_models
    for a, g in zip(carried.params["_resident"]["layers"],
                    own.params["_resident"]["layers"]):
        for x, y in zip(a, g):
            torch.testing.assert_close(y, x, rtol=0, atol=0)
    d = jm.args.decoder_config.hidden_size
    proj01 = np.random.RandomState(b).randn(2, b, d).astype(np.float32)
    want = np.asarray(jres.resident_decode_frame(
        jm.params["_resident"], jm.args, jnp.asarray(proj01),
        jnp.zeros((1,), jnp.int32), 0.0))
    for tm in (carried, own):
        got = tres.resident_decode_frame(
            tm.params["_resident"], tm.args, torch.from_numpy(proj01),
            torch.zeros((), dtype=torch.int32), 0.0).numpy()
        np.testing.assert_array_equal(got, want)


def test_int8_head_runs_dispatched_and_batched(base_params):
    """A model whose only quantized leaf is the int8 head: no kernel-3
    tables (its head is not the kernel's), and `generate_tokens_batch` and
    the continuous engine give each row the frames of its solo run (the
    head's activation codes are per row)."""
    tm = torch_model_from_jax(_jax_model(base_params))
    tquant.quantize_model(tm, mode="w8a8", min_size=0,
                          targets=("audio_head",))
    assert not tres.prepare_resident_decoder(tm)
    prompts = [text_prompt(tm.args, s, seed=s) for s in (5, 9)]
    solo = []
    for p, m in prompts:
        f, n = tgen.generate_tokens(tm, p, m, 4, temperature=0.0)
        solo.append(np.asarray(f[:int(n)]))
    frames, n = tgen.generate_tokens_batch(
        tm, [p for p, _ in prompts], [m for _, m in prompts], 4,
        temperature=0.0)
    eng = ContinuousEngine(tm, n_slots=2, max_frames=4, max_prompt_bucket=32,
                           capacity_slack=16, frames_per_step=2, codec=False,
                           generator=torch.Generator().manual_seed(7))
    results = [eng.submit_prompt(p, m, max_frames=4) for p, m in prompts]
    eng.run_until_idle()
    for row, want in enumerate(solo):
        np.testing.assert_array_equal(frames[:int(n[row]), row], want)
        np.testing.assert_array_equal(results[row].wait(0), want)


def test_quantize_model_modes_and_head_targets(base_params):
    """"audio_head" among the targets: the 8-bit dict in W8A8 and W4A8
    mode, skipped in affine mode; an unknown mode raises."""
    for mode, is_dict in (("w8a8", True), ("w4a8", True), ("affine", False)):
        tm = torch_model_from_jax(_jax_model(base_params))
        tquant.quantize_model(tm, mode=mode, min_size=0,
                              targets=("audio_head",))
        head = tm.params["audio_head"]
        assert isinstance(head, dict) == is_dict, mode
        if is_dict:
            assert int(head["weight_q"].abs().max()) > 7  # 8-bit codes
    with pytest.raises(ValueError, match="'w4a8'"):
        tquant.quantize_model(tm, mode="int3")


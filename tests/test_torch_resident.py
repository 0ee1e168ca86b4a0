"""PyTorch port vs JAX package: the whole-frame decoder (kernel 3) on the
tiny config — its tables, one greedy frame at B = 1, 3 and 16, chunking,
end-to-end generation, teacher forcing and the T > 0 distribution — and the
default device of the port's entry points.

The JAX side runs as its own tests run it: `resident_decode_frame` in
Pallas interpret mode on the CPU. The port's wrapper takes its plain
version on CPU tensors. Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from conftest import tiny_args
from torch_helpers import text_prompt, to_torch, torch_model_from_jax
from csm_mlx_tpu import generation as jgen
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu.ops import quant as jquant
from csm_mlx_tpu.ops import resident_decoder as jres
from csm_mlx_tpu_torch import bridge
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch.models import csm as tcsm
from csm_mlx_tpu_torch.ops import quant as tquant
from csm_mlx_tpu_torch.ops import resident_decoder as tres
from csm_mlx_tpu_torch.ops.rope import rope_cache_for as trope_cache
from csm_mlx_tpu_torch.ops.sampling import SamplerConfig


@pytest.fixture(scope="module")
def models():
    """A tiny JAX CSM, W8A8 (fused, decoder + projection, min_size 1) with
    its resident tables, as in tests/test_resident_decoder.py; the port's
    model carried from it (its `_resident` bridged); and a port model from
    the same params without tables, which prepares its own."""
    jm = jcsm.CSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(7))
    jm.params["audio_head"] = jax.random.normal(
        jax.random.PRNGKey(8), jm.params["audio_head"].shape,
        dtype=jnp.float32)
    jquant.quantize_model(jm, mode="w8a8", min_size=1,
                          targets=("decoder", "projection"), fuse=True)
    assert jres.prepare_resident_decoder(jm)
    carried = torch_model_from_jax(jm)
    own = tcsm.CSM(carried.args, params=to_torch(
        {k: v for k, v in jm.params.items() if k != "_resident"}),
        dtype=torch.float32)
    assert tres.prepare_resident_decoder(own)
    return jm, carried, own


def _proj01(args, b, seed):
    d = args.decoder_config.hidden_size
    return np.random.RandomState(seed).randn(2, b, d).astype(np.float32)


def _jax_frame(jm, proj01):
    return np.asarray(jres.resident_decode_frame(
        jm.params["_resident"], jm.args, jnp.asarray(proj01),
        jnp.zeros((1,), jnp.int32), 0.0))


def _port_frame(tm, proj01):
    return tres.resident_decode_frame(tm.params["_resident"], tm.args,
                                      torch.from_numpy(proj01),
                                      torch.zeros((), dtype=torch.int32),
                                      0.0).numpy()


def test_tables_match_jax(models):
    """The port's own tables against JAX's, carried through the bridge."""
    _, carried, own = models
    want, got = carried.params["_resident"], own.params["_resident"]
    for lw_want, lw_got in zip(want["layers"], got["layers"]):
        for a, b in zip(lw_want, lw_got):
            assert a.dtype == b.dtype and a.shape == b.shape
            torch.testing.assert_close(b, a, rtol=0, atol=0)
    torch.testing.assert_close(got["norm"], want["norm"], rtol=0, atol=0)
    torch.testing.assert_close(got["audio_head_q"], want["audio_head_q"],
                               rtol=0, atol=0)
    np.testing.assert_array_max_ulp(got["audio_head_s"].numpy(),
                                    want["audio_head_s"].numpy(), maxulp=1)
    tab_w, tab_g = want["embed_tab"], got["embed_tab"]
    assert tab_g.shape == tab_w.shape == (
        (carried.args.n_audio_codebooks - 2) * carried.args.n_audio_vocab,
        carried.args.decoder_config.hidden_size)
    torch.testing.assert_close(tab_g, tab_w, rtol=1e-6,
                               atol=1e-6 * tab_w.abs().max().item())
    torch.testing.assert_close(got["rope_cs"], want["rope_cs"], rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("fault", ["none", "misaligned", "strided",
                                   "shape", "dtype"])
def test_check_tables_takes_the_kernel_layout(models, fault):
    """The kernel's wrapper takes the port's own tables as they are, and
    refuses a code table that breaks the layout the kernel reads: codes off
    a 16-byte boundary (its bulk copies), not contiguous, or of another
    shape or type."""
    _, _, own = models
    res = own.params["_resident"]
    layers = [list(lw) for lw in res["layers"]]
    t = layers[1][6]  # a gate-up code table
    if fault == "misaligned":
        buf = torch.empty(t.numel() + 1, dtype=torch.int8)
        layers[1][6] = buf[1:].view(t.shape)
        layers[1][6].copy_(t)
    elif fault == "strided":
        layers[1][6] = t.t().contiguous().t()
    elif fault == "shape":
        layers[1][6] = t[:-16]
    elif fault == "dtype":
        layers[1][6] = t.float()
    broken = dict(res, layers=layers)
    if fault == "none":
        tres._check_tables(broken, own.args, torch.device("cpu"))
        return
    want = {"misaligned": "aligned", "strided": "contiguous",
            "shape": "want", "dtype": "want"}[fault]
    with pytest.raises(ValueError, match=want):
        tres._check_tables(broken, own.args, torch.device("cpu"))


@pytest.mark.parametrize("tables", ["carried", "port"])
@pytest.mark.parametrize("b,seed", [(1, 0), (1, 1), (2, 3), (3, 2), (8, 4)])
def test_frame_equals_jax_kernel(models, tables, b, seed):
    """Greedy tokens of one frame equal the JAX kernel's (interpret mode),
    from JAX's tables carried by the bridge and from the port's own."""
    jm, carried, own = models
    tm = carried if tables == "carried" else own
    proj01 = _proj01(jm.args, b, seed)
    want = _jax_frame(jm, proj01)
    got = _port_frame(tm, proj01)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert not got[0].any() and got.max() < jm.args.n_audio_vocab
    np.testing.assert_array_equal(got, want)


def test_b16_rows_equal_jax_b1(models):
    """JAX keeps its KV in bf16 past B = 8, the port in f32 at every B: each
    port row at B = 16 equals the JAX kernel's B = 1 run of that row."""
    jm, carried, _ = models
    proj01 = _proj01(jm.args, 16, 5)
    got = _port_frame(carried, proj01)
    for row in (0, 7, 15):
        want = _jax_frame(jm, proj01[:, row:row + 1])
        np.testing.assert_array_equal(got[:, row:row + 1], want)


def _frame_inputs(tm, b, seed):
    rng = np.random.RandomState(seed)
    last_hidden = torch.from_numpy(
        rng.randn(b, tm.args.backbone_dim).astype(np.float32))
    history = torch.full((b, 64), -1, dtype=torch.long)
    cos_d, sin_d = trope_cache(tm.args.decoder_config,
                               tm.args.n_audio_codebooks + 1, "cpu")
    return last_hidden, history, cos_d, sin_d


def test_chunked_frame_equals_single_call(models, monkeypatch):
    """B = 5 with a 2-row cap runs chunks of 2, 2 and 1 and gives the
    frame of one 5-row call; a custom sampler takes the dispatched path."""
    _, carried, _ = models
    tm = carried
    h, hist, cos_d, sin_d = _frame_inputs(tm, 5, 9)
    greedy = SamplerConfig(temperature=0.0)
    whole, _ = tgen._decode_frame(tm.params, tm.args, h, None, hist.clone(),
                                  greedy, (), cos_d, sin_d)
    calls = []
    real = tres.resident_decode_frame

    def counting(res, args, proj01, seed, temperature):
        calls.append(proj01.shape[1])
        return real(res, args, proj01, seed, temperature)

    monkeypatch.setattr(tres, "resident_decode_frame", counting)
    monkeypatch.setattr(tres, "RESIDENT_MAX_BATCH", 2)
    chunked, _ = tgen._decode_frame(tm.params, tm.args, h, None, hist.clone(),
                                    greedy, (), cos_d, sin_d)
    assert calls == [2, 2, 1]
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    assert whole.shape == (5, tm.args.n_audio_codebooks)

    class Custom(SamplerConfig):
        pass

    calls.clear()
    frame, _ = tgen._decode_frame(tm.params, tm.args, h, None, hist.clone(),
                                  Custom(temperature=0.0), (), cos_d, sin_d)
    assert calls == [] and frame.shape == whole.shape


@pytest.mark.parametrize("s", [4, 40])
def test_generate_tokens_equals_jax_resident(models, monkeypatch, s):
    """Port `generate_tokens` through the plain kernel-3 path against JAX
    `generate_tokens` with its resident kernel in interpret mode: greedy
    frames equal, frame for frame."""
    jm, carried, _ = models
    prompt, mask = text_prompt(jm.args, s, seed=s)
    monkeypatch.setenv("CSM_TPU_RESIDENT_DECODER", "interpret")
    jgen._build_generate_tokens.cache_clear()
    try:
        want, n_want = jgen.generate_tokens(jm, prompt, mask, 3,
                                            temperature=0.0)
    finally:
        jgen._build_generate_tokens.cache_clear()
    calls = []
    real = tres.resident_decode_frame

    def counting(*a):
        calls.append(a[2].shape[1])
        return real(*a)

    monkeypatch.setattr(tres, "resident_decode_frame", counting)
    got, n_got = tgen.generate_tokens(carried, prompt, mask, 3,
                                      temperature=0.0)
    assert calls == [1, 1, 1]  # one whole-frame call per frame
    assert n_got == n_want == 3
    np.testing.assert_array_equal(got, want)


def test_teacher_forcing_reproduces_own_run(models):
    """Forced with its own picks, the plain version returns the same tokens
    and logits; at T = 0 each logits row's argmax is the token."""
    _, carried, _ = models
    res, args = carried.params["_resident"], carried.args
    proj01 = torch.from_numpy(_proj01(args, 4, 3))
    toks, logits = tres.resident_decode_frame_plain(res, args, proj01, 0.0)
    toks2, logits2 = tres.resident_decode_frame_plain(res, args, proj01, 0.0,
                                                      forced=toks.long())
    torch.testing.assert_close(toks2, toks, rtol=0, atol=0)
    torch.testing.assert_close(logits2, logits, rtol=0, atol=0)
    assert logits.shape == (args.n_audio_codebooks - 1, 4, args.n_audio_vocab)
    torch.testing.assert_close(logits.argmax(-1).int(), toks[1:], rtol=0,
                               atol=0)


def chi_square_p(samples: np.ndarray, probs: np.ndarray) -> float:
    """p-value of samples against probs, over the bins whose expected count
    is >= 5 and one pooled bin of the rest."""
    n = len(samples)
    observed = np.bincount(samples, minlength=len(probs)).astype(np.float64)
    expected = probs.astype(np.float64) * n
    big = expected >= 5
    obs = list(observed[big]) + [observed[~big].sum()]
    exp = list(expected[big]) + [expected[~big].sum()]
    if exp[-1] < 5:  # too little left to pool: fold it into the last bin
        obs[-2] += obs.pop()
        exp[-2] += exp.pop()
    obs, exp = np.array(obs), np.array(exp)
    stat = float(((obs - exp) ** 2 / exp).sum())
    return float(stats.chi2.sf(stat, len(obs) - 1))


def test_temperature_sampling_distribution(models):
    """At T = 0.8 the plain version's codebook-1 picks over 2048 rows of one
    proj01 follow softmax(logits_1 / T) (chi-square, p >= 1e-3). The head
    is scaled by 0.2 so that many tokens carry probability."""
    _, carried, _ = models
    args = carried.args
    res = dict(carried.params["_resident"])
    v = args.n_audio_vocab
    tres.set_resident_audio_head(res, carried.params["audio_head"] * 0.2,
                                 res["audio_head_q"].shape[1])
    proj01 = torch.from_numpy(np.repeat(_proj01(args, 1, 4), 2048, axis=1))
    gen = torch.Generator().manual_seed(0)
    toks, logits = tres.resident_decode_frame_plain(res, args, proj01, 0.8,
                                                    generator=gen)
    probs = torch.softmax(logits[0, 0] / 0.8, dim=-1).double().numpy()
    assert (probs >= 5 / 2048).sum() >= 10  # a spread-out distribution
    p = chi_square_p(toks[1].numpy(), probs)
    assert p >= 1e-3, p
    assert toks.min() >= 0 and toks.max() < v


def test_default_device(models, monkeypatch):
    """With params, the model runs where they are; with none and no GPU,
    the entry points raise and name device="cpu"; `quantize_model` on a
    CPU model prepares no resident tables."""
    jm, carried, _ = models
    assert carried.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcsm.CSM(carried.args)
    from csm_mlx_tpu_torch.models.mimi import Mimi
    from test_mimi import TINY as TINY_MIMI

    with pytest.raises(RuntimeError, match='device="cpu"'):
        Mimi(bridge.mimi_config_from(TINY_MIMI))
    raw = tcsm.CSM(carried.args, dtype=torch.float32, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    assert raw.device == torch.device("cpu")
    tquant.quantize_model(raw, mode="w8a8", min_size=1, fuse=True)
    assert "_resident" not in raw.params
    assert "qkv_proj" in raw.params["decoder"]["layers"][0]["self_attn"]

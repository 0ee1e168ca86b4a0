"""PyTorch port vs JAX package: the samplers and logits processors
(`ops/sampling.py`) on fixed logits made with numpy from a seed.

Filters, greedy sampling and the processors are deterministic and must
equal JAX's: the filters to the bit in which tokens they keep (atol 1e-6
on the kept logits, fp32 divisions on both sides), greedy tokens exactly.
At T > 0 the PRNGs differ, so draws are held to JAX's filtered support
(never a token JAX filters out) and to the softmax of the filtered logits
by a chi-square (p >= 1e-3, bins with >= 5 expected draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from csm_mlx_tpu.ops import sampling as js
from csm_mlx_tpu_torch.ops import sampling as ts

ATOL = 1e-6


def _logits(b=4, v=64, seed=0, scale=2.0):
    return (np.random.RandomState(seed).randn(b, v) * scale).astype(np.float32)


def _kept(logits):
    return np.asarray(logits) > -1e29


@pytest.mark.parametrize("name,fn_args", [
    ("_top_k_filter", (5,)),
    ("_top_k_filter", (1,)),
    ("_top_k_filter", (0,)),
    ("_min_p_filter", (0.1, 1)),
    ("_min_p_filter", (0.9, 3)),
    ("_top_p_filter", (0.5, 1)),
    ("_top_p_filter", (0.9, 1)),
    ("_top_p_filter", (0.05, 4)),
])
def test_filters_equal_jax(name, fn_args):
    logits = _logits(seed=len(name) + len(fn_args))
    want = np.asarray(getattr(js, name)(jnp.asarray(logits), *fn_args))
    got = getattr(ts, name)(torch.from_numpy(logits), *fn_args).numpy()
    np.testing.assert_array_equal(_kept(got), _kept(want))
    np.testing.assert_allclose(got[_kept(got)], want[_kept(want)],
                               atol=ATOL, rtol=0)
    assert np.all(got[~_kept(got)] == ts.NEG_INF)


def test_top_p_keeps_the_first_token():
    """A nucleus smaller than the top token's mass keeps that token alone."""
    logits = np.array([[5.0, 0.0, -1.0, -2.0]], np.float32)
    got = ts._top_p_filter(torch.from_numpy(logits), 0.01, 1).numpy()
    np.testing.assert_array_equal(_kept(got), [[True, False, False, False]])


@pytest.mark.parametrize("cfg", [
    dict(temperature=0.0),
    dict(temperature=0.0, top_k=3, top_p=0.5, min_p=0.2),
])
def test_greedy_equals_jax(cfg):
    logits = _logits(b=6, seed=3)
    logits[2, [4, 9]] = 20.0  # a tie: the first index on both sides
    want = np.asarray(js.SamplerConfig(**cfg)(jax.random.PRNGKey(0),
                                              jnp.asarray(logits)))
    got = ts.SamplerConfig(**cfg)(None, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def test_make_sampler_fields():
    smp = ts.make_sampler(0.7, top_p=0.9, min_p=0.05, top_k=40,
                          min_tokens_to_keep=2)
    assert smp == ts.SamplerConfig(0.7, 0.9, 0.05, 40, 2)
    assert {f: getattr(smp, f) for f in ("temperature", "top_p", "min_p",
                                         "top_k", "min_tokens_to_keep")} == \
        {f: getattr(js.make_sampler(0.7, 0.9, 0.05, 40, 2), f)
         for f in ("temperature", "top_p", "min_p", "top_k",
                   "min_tokens_to_keep")}


def _chi_square_p(samples, probs):
    n = len(samples)
    observed = np.bincount(samples, minlength=len(probs)).astype(np.float64)
    expected = probs.astype(np.float64) * n
    big = expected >= 5
    obs = np.append(observed[big], observed[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] < 5:
        obs, exp = obs[:-1], exp[:-1]
        obs[-1] += observed[~big].sum()
        exp[-1] += expected[~big].sum()
    return float(stats.chi2.sf(((obs - exp) ** 2 / exp).sum(), len(obs) - 1))


@pytest.mark.parametrize("cfg", [
    dict(temperature=0.8),
    dict(temperature=0.8, top_k=8),
    dict(temperature=1.3, top_p=0.7),
    dict(temperature=0.8, min_p=0.1, min_tokens_to_keep=3),
    dict(temperature=0.8, top_k=12, min_p=0.05, top_p=0.9),
])
def test_sampled_draws_follow_the_jax_filtered_softmax(cfg):
    """4096 draws of one row: each inside JAX's filtered support, their
    histogram against softmax of JAX's filtered logits / T."""
    logits = _logits(b=1, v=48, seed=7, scale=1.5)
    n = 4096
    x = jnp.asarray(logits) / cfg["temperature"]
    if cfg.get("top_k"):
        x = js._top_k_filter(x, cfg["top_k"])
    if cfg.get("min_p"):
        x = js._min_p_filter(x, cfg["min_p"], cfg.get("min_tokens_to_keep", 1))
    if cfg.get("top_p"):
        x = js._top_p_filter(x, cfg["top_p"], cfg.get("min_tokens_to_keep", 1))
    support = _kept(x)[0]
    probs = np.asarray(jax.nn.softmax(x, axis=-1))[0]
    rows = torch.from_numpy(np.repeat(logits, n, axis=0))
    draws = ts.SamplerConfig(**cfg)(torch.Generator().manual_seed(11),
                                    rows).numpy()
    assert support[draws].all()
    assert len(set(draws.tolist())) > 1
    p = _chi_square_p(draws, probs)
    assert p >= 1e-3, p


def test_repetition_penalty_equals_jax():
    """Only the last `context_size` valid entries count; -1 is padding; a
    token seen twice is penalised once; rows are independent."""
    logits = _logits(b=3, v=20, seed=5)
    history = np.full((3, 64), -1, np.int32)
    history[0, -4:] = [3, 7, 7, 1]
    history[1, -30:] = np.arange(30) % 20   # older entries fall out of 20
    history[2, :10] = [5] * 10              # far outside the window
    history[2, -1] = 0                      # token 0 twice with the pad
    for penalty, ctx in ((1.3, 20), (0.8, 3), (2.0, 64)):
        want = np.asarray(js.RepetitionPenalty(penalty, ctx)(
            jnp.asarray(history), jnp.asarray(logits)))
        got = ts.RepetitionPenalty(penalty, ctx)(
            torch.from_numpy(history).long(), torch.from_numpy(logits)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # a 1-D history is one row
    want = np.asarray(js.RepetitionPenalty()(jnp.asarray(history[0]),
                                             jnp.asarray(logits[:1])))
    got = ts.RepetitionPenalty()(torch.from_numpy(history[0]).long(),
                                 torch.from_numpy(logits[:1])).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_logit_bias_and_processor_chain_equal_jax():
    logits = _logits(b=2, v=16, seed=9)
    history = np.full((2, 64), -1, np.int32)
    history[:, -3:] = [[2, 4, 2], [9, 9, 0]]
    kw = dict(logit_bias={3: 2.5, 0: -1.0, 15: 0.25}, repetition_penalty=1.5,
              repetition_context_size=10)
    jp, tp = js.make_logits_processors(**kw), ts.make_logits_processors(**kw)
    assert [type(p).__name__ for p in tp] == [type(p).__name__ for p in jp] \
        == ["LogitBias", "RepetitionPenalty"]
    want = np.asarray(js.apply_processors(jp, jnp.asarray(history),
                                          jnp.asarray(logits)))
    got = ts.apply_processors(tp, torch.from_numpy(history).long(),
                              torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert ts.make_logits_processors() == js.make_logits_processors() == ()
    assert ts.make_logits_processors(repetition_penalty=1.0) == ()


def test_history_size_guard():
    with pytest.raises(ValueError, match="HISTORY_SIZE"):
        ts.make_logits_processors(repetition_penalty=1.2,
                                  repetition_context_size=ts.HISTORY_SIZE + 1)
    assert ts.make_logits_processors(
        repetition_penalty=1.2,
        repetition_context_size=ts.HISTORY_SIZE)[0].context_size == 64
    assert ts.HISTORY_SIZE == js.HISTORY_SIZE

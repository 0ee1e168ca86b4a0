"""The generator: one seed gives the same requests, two seeds the same
sizes in another order with other contents."""

import numpy as np
import pytest

from gpubench import traffic
from gpubench.run import Cell


@pytest.mark.parametrize("cell", ["w8a8-stream", "w8a8-serve"])
def test_same_seed_same_requests(cell):
    c = Cell(cell)
    a = traffic.generate(c.mix, c.config, 2 ** 31 + 77, 200, stream=1)
    b = traffic.generate(c.mix, c.config, 2 ** 31 + 77, 200, stream=1)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert np.array_equal(x.mask, y.mask)
        assert (x.frames, x.greedy, x.context) == (y.frames, y.greedy,
                                                   y.context)


@pytest.mark.parametrize("cell", ["w8a8-stream", "w8a8-serve"])
def test_two_seeds_same_work_other_order(cell):
    c = Cell(cell)
    n = 4 * int(c.mix["block"])
    a = traffic.generate(c.mix, c.config, 5, n, stream=1)
    b = traffic.generate(c.mix, c.config, 3_000_000_019, n, stream=1)
    assert sorted(r.frames for r in a) == sorted(r.frames for r in b)
    assert sum(r.greedy for r in a) == sum(r.greedy for r in b)
    assert sum(r.context for r in a) == sum(r.context for r in b)
    assert [r.frames for r in a] != [r.frames for r in b]
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    # the warm-up's requests are another stream of the same seed
    w = traffic.generate(c.mix, c.config, 5, n, stream=0)
    assert [r.frames for r in w] != [r.frames for r in a]


def test_shapes_follow_the_mix():
    c = Cell("w8a8-serve")
    reqs = traffic.generate(c.mix, c.config, 11, 400, stream=1)
    k = c.config["audio_num_codebooks"]
    lo, hi = c.mix["frames"]["lo"], c.mix["frames"]["hi"]
    assert all(lo <= r.frames <= hi for r in reqs)
    ctx = [r for r in reqs if r.context]
    assert len(ctx) == 40
    for r in ctx:
        assert 250 <= r.prompt.shape[0] <= 321
        audio = r.mask[:, :k].all(axis=1)
        assert audio.sum() == 225 and not r.mask[audio, k].any()
    for r in reqs:
        if not r.context:
            assert 12 <= r.prompt.shape[0] <= 48
            assert r.mask[:, k].all() and not r.mask[:, :k].any()
    assert np.median([r.frames for r in reqs]) == pytest.approx(38, abs=2)


def test_context_audio_is_the_seeds():
    c = Cell("w8a8-voice")
    a = traffic.context_audio(c.mix, c.config, 2 ** 31 + 5)
    b = traffic.context_audio(c.mix, c.config, 2 ** 31 + 5)
    other = traffic.context_audio(c.mix, c.config, 6)
    rate = c.config["mimi"]["sampling_rate"]
    assert [len(x[2]) for x in a] == [s * rate for s in
                                      c.mix["context_audio"]["segment_seconds"]]
    for (ta, ma, xa), (tb, mb, xb) in zip(a, b):
        assert np.array_equal(ta, tb) and np.array_equal(xa, xb)
        assert 16 <= len(ta) <= 32 and ma[:, -1].all()
    assert not np.array_equal(a[0][2], other[0][2])
    assert traffic.context_audio(Cell("w8a8-stream").mix, c.config, 1) == []

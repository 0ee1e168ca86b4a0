"""The readers of the port's spans (`gpubench/spans.py`) on hand-made
Chrome-trace stretches: each gives its number, and nothing without its
spans; the device idle by innermost span and the script's report."""

import pytest

from gpubench import spans, trace
from gpubench.run import Cell

MAIN, OTHER, ENGINE = (1, 1), (1, 2), (1, 7)


def _span(name, ts, end, thread=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts, "pid": thread[0], "tid": thread[1]}


def _launch(ts, corr, kernels, thread=MAIN, name="cudaLaunchKernel"):
    """A runtime call at `ts` and the device events it launched."""
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
           "dur": 1.0, "pid": thread[0], "tid": thread[1],
           "args": {"correlation": corr}}]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": b - a,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}
           for a, b in kernels]
    return ev


def _stream_trace(with_spans=True):
    """Two requests in a 1,000 us stretch. The first: an assemble with one
    encode whose kernel outlasts it (12 to 25), a prefill from 30 whose
    first frame's kernel ends at 90, three replays with 17 and 20 us of
    device idle between them (the EOS read's kernel and the chunk's copy
    inside the first gap). The second: a prefill from 310 to its first
    frame's end at 350, one replay. A launch on another thread under the
    first prefill is not its."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
           "ts": 0.0, "dur": 1000.0}]
    ev += _launch(14, 100, [(15, 25)])
    ev += _launch(35, 101, [(40, 70)])
    ev += _launch(36, 300, [(500, 900)], thread=OTHER)
    ev += _launch(65, 102, [(70, 90)])
    ev += _launch(101, 103, [(110, 130), (130, 150)], name="cudaGraphLaunch")
    ev += _launch(150, 104, [(152, 153)])
    ev += _launch(154, 105, [(155, 157)], name="cudaMemcpyAsync")
    ev += _launch(161, 106, [(170, 200)], name="cudaGraphLaunch")
    ev += _launch(211, 107, [(220, 250)], name="cudaGraphLaunch")
    ev += _launch(312, 201, [(315, 330)])
    ev += _launch(322, 202, [(330, 350)])
    ev += _launch(361, 203, [(370, 400)], name="cudaGraphLaunch")
    if with_spans:
        ev += [_span(*s) for s in (
            ("stream.assemble", 10, 30), ("stream.encode", 12, 20),
            ("stream.prefill", 30, 60), ("stream.first", 60, 80),
            ("stream.replay", 100, 105), ("stream.eos", 150, 153),
            ("stream.chunk", 154, 158), ("stream.replay", 160, 165),
            ("stream.replay", 210, 215),
            ("stream.assemble", 300, 310), ("stream.prefill", 310, 320),
            ("stream.first", 320, 330), ("stream.replay", 360, 365))]
    return trace.Trace(ev)


def _serve_trace(with_spans=True):
    """Two engine iterations (take, admit, block, fetch with its wait) and
    an idle wait; a fetch the profiler's stop cut short ends past the
    stretch."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
           "ts": 0.0, "dur": 1000.0}]
    ev += _launch(53, 400, [(60, 150)], thread=ENGINE,
                  name="cudaGraphLaunch")
    if with_spans:
        ev += [_span(*s, thread=ENGINE) for s in (
            ("engine.take", 10, 12), ("engine.admit", 12, 52),
            ("engine.block", 52, 62), ("engine.fetch", 62, 162),
            ("engine.fetch_wait", 64, 154),
            ("engine.take", 170, 172), ("engine.admit", 172, 192),
            ("engine.block", 192, 202),
            ("engine.fetch", 202, 302), ("engine.fetch_wait", 204, 294),
            ("engine.idle", 310, 400), ("engine.fetch", 990, 1100))]
    return trace.Trace(ev)


def test_spans_by_name_and_launches():
    sp = spans.Spans(_stream_trace())
    assert [e["ts"] for e in sp.named("stream.replay")] == [100, 160, 210,
                                                             360]
    (prefill, _) = sp.named("stream.prefill")
    assert [(k["ts"], spans.end(k)) for k in sp.launched([prefill])] \
        == [(40, 70)]
    assert sp.device_idle_us(150, 170) == pytest.approx(17.0)
    assert [len(r["stream.replay"]) for r in sp.requests()] == [3, 1]
    serve = spans.Spans(_serve_trace())
    # the fetch cut short by the profiler's stop is left out
    assert len(serve.named("engine.fetch")) == 2


def test_idle_under_the_innermost_span():
    # the stream's 372 us of idle: 3 under the encode inside the assemble,
    # 17 under the assemble alone, the EOS read's and the copy's 2 each
    got = spans.Spans(_stream_trace()).idle_under(prefix="stream.")
    assert got == pytest.approx({
        spans.NO_SPAN: 313.0, "stream.assemble": 17.0, "stream.encode": 3.0,
        "stream.prefill": 15.0, "stream.eos": 2.0, "stream.chunk": 2.0,
        "stream.replay": 20.0})
    # the engine's 910 us: a fetch's own time outside its wait counts to it
    got = spans.Spans(_serve_trace()).idle_under(prefix="engine.")
    assert got == pytest.approx({
        spans.NO_SPAN: 626.0, "engine.take": 4.0, "engine.admit": 60.0,
        "engine.block": 18.0, "engine.fetch": 18.0,
        "engine.fetch_wait": 94.0, "engine.idle": 90.0})
    # only the chosen spans count
    got = spans.Spans(_serve_trace()).idle_under("engine.fetch")
    assert got == pytest.approx({spans.NO_SPAN: 798.0, "engine.fetch": 112.0})


def test_stream_reader_and_request_phases():
    layer = dict(trace=_stream_trace())
    voice = Cell("w8a8-voice")
    # 17 and 20 us of idle inside the first request, none across the two
    assert voice.reader("frame_idle_ms.stream").read(layer) \
        == pytest.approx(0.0185)
    # (90 - 30) and (350 - 310) us; (25 - 12) us in the first request
    got = spans.request_phases_ms(spans.Spans(_stream_trace()))
    assert got == {"prefill": pytest.approx([0.06, 0.04]),
                   "encode": pytest.approx([0.013])}


def test_serve_readers():
    layer = dict(trace=_serve_trace())
    serve = Cell("w8a8-serve")
    # admits of 40 and 20 us; 100 us of idle under take, admit, block and
    # fetch (not its wait), over 2 blocks
    assert serve.reader("admit_issue_ms.serve").read(layer) \
        == pytest.approx(0.03)
    assert serve.reader("block_host_ms.serve").read(layer) \
        == pytest.approx(0.05)


@pytest.mark.parametrize("cell,make", [("w8a8-voice", _stream_trace),
                                       ("w8a8-serve", _serve_trace)])
def test_report(cell, make):
    c = Cell(cell)
    # the other readers get what a driver hands them, with no requests
    layer = dict(trace=make(), counts=None, rows=1, config=c.config,
                 span_s=1e-3, requests=[])
    got = spans.report(c, layer)
    assert got["window_ms"] == pytest.approx(1.0)
    assert sum(got["idle_ms_under"].values()) \
        == pytest.approx(1.0 - got["busy_ms"])
    assert got["metrics"]["idle_share." + cell.split("-")[1]
                          .replace("voice", "stream")] is not None
    if cell == "w8a8-voice":
        assert got["requests"] == 2
        assert got["spans"]["stream.replay"] == {
            "count": 4, "wall_ms": pytest.approx(0.02)}
        assert got["request_ms"]["prefill"]["n"] == 2
        assert got["metrics"]["frame_idle_ms.stream"] \
            == pytest.approx(0.0185)
    else:
        assert "requests" not in got
        assert got["spans"]["engine.block"]["count"] == 2
        assert got["metrics"]["block_host_ms.serve"] == pytest.approx(0.05)


@pytest.mark.parametrize("cell,names", [
    ("w8a8-voice", ("frame_idle_ms.stream",)),
    ("w8a8-serve", ("admit_issue_ms.serve", "block_host_ms.serve"))])
def test_readers_give_nothing_without_their_spans(cell, names):
    c = Cell(cell)
    bare = (_stream_trace if cell == "w8a8-voice" else _serve_trace)(False)
    for n in names:
        assert c.reader(n).read({}) is None
        assert c.reader(n).read(dict(trace=bare)) is None

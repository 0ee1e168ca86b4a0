"""Reading a Chrome trace: the stretch's window, busy time as a union,
kernels grouped by the graph launch that ran them, the per-layer readers
and the breakdown."""

import pytest

from gpubench import metrics_common, roofline, trace
from gpubench.run import Cell
from tiny import tiny_config


def _trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
           "ts": 100.0, "dur": 100.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
           "ts": 110.0, "dur": 5.0, "args": {"correlation": 7}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 150.0,
           "dur": 30.0}]
    # a replayed graph: two overlapping kernels and a third; an eager one
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d,
            "args": {"correlation": c}}
           for n, ts, d, c in (
               ("void w8a8_matvec_kernel<1>(int)", 120.0, 10.0, 7),
               ("void quant_rows_kernel<bf16>(int)", 125.0, 10.0, 7),
               ("resident_frame_kernel", 140.0, 5.0, 7),
               ("elementwise_kernel", 190.0, 20.0, 9))]
    return trace.Trace(ev)


def test_window_busy_and_graphs():
    tr = _trace()
    assert (tr.t0, tr.t1, tr.window_us) == (100.0, 200.0, 100.0)
    # 120-135 and 140-145 and 190-200 (clipped at the stretch's end)
    assert tr.busy_us(tr.kernels) == pytest.approx(30.0)
    graphs = tr.by_graph_launch()
    assert list(graphs) == [7] and len(graphs[7]) == 3
    assert tr.idle_gaps() == [(100.0, 120.0), (135.0, 140.0),
                              (145.0, 190.0)]


def test_breakdown_names_kernels_and_gaps():
    b = _trace().breakdown()
    names = dict(b["device_ops"])
    assert names["w8a8_matvec_kernel"] == pytest.approx(1e-5)
    gaps = dict(b["idle_gaps"])
    # each gap named by what the host did at its middle: 100-120 the
    # graph's launch (110-115), 135-140 nothing, 145-190 aten::copy_
    assert gaps["cudaGraphLaunch"] == pytest.approx(20e-6)
    assert gaps["host idle"] == pytest.approx(5e-6)
    assert gaps["aten::copy_"] == pytest.approx(45e-6)


def _replays_trace(cfg: dict, graphs: int, keep_k1: int = None):
    """A stretch of `graphs` replayed frames at one row: each a graph launch
    whose kernels are one frame's kernel-1 launches (10 us each, one after
    another), a row quantization (5 us), kernel 3 (100 us) and an
    elementwise kernel (5 us); 50 us of idle between graphs."""
    _, per_frame = roofline.k1_frame_bound_s(cfg, 1)
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
           "ts": 0.0, "dur": 1000.0 * graphs}]
    for g in range(graphs):
        t = 1000.0 * g
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
                   "ts": t, "dur": 5.0, "args": {"correlation": g + 1}})
        names = ["w8a8_matvec_kernel"] * per_frame + [
            "quant_rows_kernel", "resident_frame_kernel", "elementwise"]
        durs = [10.0] * per_frame + [5.0, 100.0, 5.0]
        if g == 0 and keep_k1 is not None:
            names, durs = names[per_frame - keep_k1:], durs[per_frame - keep_k1:]
        t += 50.0
        for n, d in zip(names, durs):
            ev.append({"ph": "X", "cat": "kernel", "name": n, "ts": t,
                       "dur": d, "args": {"correlation": g + 1}})
            t += d
    return trace.Trace(ev), per_frame


def test_readers_read_the_trace():
    """Each reader works its number out of the raw stretch: the replays, the
    counters, the rows and the configuration."""
    cfg = tiny_config()
    tr, per_frame = _replays_trace(cfg, 3)
    c = Cell("w8a8-stream")
    layer = dict(trace=tr, rows=1, config=cfg,
                 counts={"w8a8_matvec": 3 * per_frame,
                         "resident_decode_frame": 3},
                 span_s=0.5, requests=[dict(rows=20, prefill=True,
                                            frames=[0, 1, 2])])
    got = {m["name"]: c.reader(m["name"]).read(layer) for m in c.per_layer()}
    k1_bound, _ = roofline.k1_frame_bound_s(cfg, 1)
    k1_time = 3 * (per_frame * 10.0 + 5.0) / 1e6
    assert got["k1_roofline.stream"] == pytest.approx(
        100 * 3 * k1_bound / k1_time)
    assert got["k3_roofline.stream"] == pytest.approx(
        100 * 3 * roofline.k3_bound_s(cfg, 1) / 300e-6)
    busy = per_frame * 10.0 + 110.0
    assert got["frame_busy_ms.stream"] == pytest.approx(busy / 1e3)
    assert got["idle_share.stream"] == pytest.approx(
        100 * (1 - busy / 1000.0))
    ops = roofline.prefill_ops(cfg, 20) + sum(
        roofline.frame_ops(cfg, 20 + j) for j in range(3))
    assert got["mfu.stream"] == pytest.approx(
        100 * ops / 0.5 / roofline.PEAK_OPS_PER_S["int8"])


def test_readers_skip_what_they_cannot_read():
    cfg = tiny_config()
    c = Cell("w8a8-stream")
    tr, per_frame = _replays_trace(cfg, 3, keep_k1=per_frame_less(cfg))
    layer = dict(trace=tr, rows=1, config=cfg,
                 counts={"w8a8_matvec": 3 * per_frame,
                         "resident_decode_frame": 3})
    # one replay lost a launch: the counters disagree, no kernel share;
    # the two complete replays still give the frame's busy time
    assert not metrics_common.gated(layer)
    assert c.reader("k1_roofline.stream").read(layer) is None
    assert c.reader("k3_roofline.stream").read(layer) is None
    assert len(metrics_common.replays(layer)) == 2
    assert c.reader("frame_busy_ms.stream").read(layer) is not None
    assert all(c.reader(m["name"]).read({}) is None for m in c.per_layer())
    s = Cell("w8a8-serve")
    assert all(s.reader(m["name"]).read({}) is None for m in s.per_layer())


def per_frame_less(cfg: dict) -> int:
    return roofline.k1_frame_bound_s(cfg, 1)[1] - 1


def test_engine_counters():
    s = Cell("w8a8-serve")
    layer = dict(engine_counts=dict(steps=10, frames_emitted=4000,
                                    frames_per_step=8, n_slots=64),
                 admit_to_first_ms=[300.0, 100.0, 200.0])
    assert s.reader("slot_use.serve").read(layer) == pytest.approx(
        100 * 4000 / (10 * 8 * 64))
    assert s.reader("admit_first_chunk_p50_ms.serve").read(layer) == 200.0

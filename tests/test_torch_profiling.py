"""The port's profiling hooks (`csm_mlx_tpu_torch/utils/profiling.py`):
JAX's three cases of `tests/test_profiling.py` (`RtfMeter`, `annotate` as
a context manager, `stop` without `start`), and `trace` writing a Chrome
trace with the span's name on the CPU."""

import json
import time

import pytest
import torch

from csm_mlx_tpu_torch.utils.profiling import RtfMeter, annotate, trace


def test_rtf_meter():
    m = RtfMeter(frame_seconds=0.08)
    m.start()
    time.sleep(0.01)
    m.tick()
    m.tick(3)
    rtf = m.stop()
    assert rtf > 0
    assert m.first_chunk_latency_s is not None
    assert m.first_chunk_latency_s >= 0.01
    assert m.history == [rtf]


def test_annotate_contextmanager():
    with annotate("test-span"):
        pass


def test_rtf_meter_stop_requires_start():
    m = RtfMeter(frame_seconds=0.08)
    with pytest.raises(RuntimeError, match="stop"):
        m.stop()
    m.start()
    m.tick()
    m.stop()
    with pytest.raises(RuntimeError, match="stop"):
        m.stop()  # a second stop would measure from a stale start
    with pytest.raises(RuntimeError, match="tick"):
        m.tick()


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        with annotate("smoke-span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "smoke-span" in names
    assert any("mm" in str(n) for n in names)

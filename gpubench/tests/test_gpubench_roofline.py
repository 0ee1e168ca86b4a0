"""The frozen byte and operation counts against the bounds PERF.md
recorded from the kernels' own tensors (H100 80GB HBM3 peaks)."""

import pytest

from gpubench import roofline
from gpubench.run import Cell


def _cfg():
    return Cell("w8a8-stream").config


def test_kernel3_b1():
    assert roofline.k3_bound_s(_cfg(), 1) * 1e6 == pytest.approx(54.1,
                                                                 abs=0.05)


def test_kernel3_b64_is_operation_bound():
    b, ops = roofline.k3_bytes_ops(_cfg(), 64)
    assert ops / roofline.PEAK_OPS_PER_S["int8"] > \
        b / roofline.HBM_BYTES_PER_S
    assert roofline.k3_bound_s(_cfg(), 64) * 1e3 == pytest.approx(0.235,
                                                                  abs=5e-4)


@pytest.mark.parametrize("rows,want_us", [(1, 10.07), (64, 10.8)])
def test_kernel1_gate_up(rows, want_us):
    assert roofline.k1_bound_s(rows, 2048, 16384) * 1e6 == pytest.approx(
        want_us, abs=0.05)


def test_flash_train_at_2_575():
    b = roofline.flash_train_bounds_s(2, 575, 32, 8, 64)
    assert b["fwd"] * 1e6 == pytest.approx(3.56, abs=0.005)
    assert b["bwd"] * 1e6 == pytest.approx(7.07, abs=0.005)


def test_frame_bound_counts_65_launches():
    bound, n = roofline.k1_frame_bound_s(_cfg(), 1)
    assert n == 65 and bound > 0


def test_ops_grow_with_context():
    cfg = _cfg()
    assert roofline.frame_ops(cfg, 1000) > roofline.frame_ops(cfg, 10) > 0
    assert roofline.prefill_ops(cfg, 64) > 2 * roofline.prefill_ops(cfg, 31)

"""`k4_ms.serve` on hand-made stretches of replayed engine blocks: kernel
4's device ms a block where every complete block holds a call in each
layer of each backbone step, nothing where one lacks a call or where no
block runs kernel 4 (the masked attention)."""

import pytest

from gpubench import roofline, trace
from gpubench.run import Cell
from tiny import tiny_config

K = 8
NS = "void (anonymous namespace)::"
FUSED = NS + "flash_decode_kernel<__nv_bfloat16, 4, 0>"
SCORES = NS + "flash_decode_kernel<__nv_bfloat16, 4, 1>"
VALUES = NS + "flash_decode_kernel<__nv_bfloat16, 4, 2>"
MERGE = NS + "flash_decode_merge_kernel<__nv_bfloat16, 4>"


def _blocks(cfg: dict, n: int, call, drop: int = None):
    """A stretch of `n` replayed blocks of K frames at 64 rows: each frame
    a backbone step (a layer's kernel-1 launches of 10 us and its
    attention, `call`: the kernels (name, us) of one kernel-4 call, or
    none), the projection's kernel-1 launch, kernel 3 (100 us) and an
    elementwise kernel; the first block's kernel-4 call `drop` left out."""
    layers = cfg["backbone"]["num_hidden_layers"]
    _, per_frame = roofline.k1_frame_bound_s(cfg, 64)
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
           "ts": 0.0, "dur": 1e5 * n}]
    for g in range(n):
        t = 1e5 * g
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaGraphLaunch", "ts": t, "dur": 5.0,
                   "args": {"correlation": g + 1}})
        kernels, c = [], 0
        for _ in range(K):
            for _ in range(layers):
                kernels += [("w8a8_matvec_kernel", 10.0)] * (
                    (per_frame - 1) // layers)
                if not (g == 0 and c == drop):
                    kernels += call
                c += 1
            kernels += [("w8a8_matvec_kernel", 10.0),
                        ("resident_frame_kernel", 100.0),
                        ("elementwise_kernel", 5.0)]
        t += 50.0
        for name, d in kernels:
            ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": t,
                       "dur": d, "args": {"correlation": g + 1}})
            t += d
    return dict(trace=trace.Trace(ev), rows=64, config=cfg, counts=None)


@pytest.mark.parametrize("call,us", [
    ([(FUSED, 20.0)], 20.0),                                # one split
    ([(SCORES, 8.0), (VALUES, 9.0), (MERGE, 1.5)], 18.5),   # split
])
def test_k4_ms_reads_kernel_4_a_block(call, us):
    cfg = tiny_config()
    layer = _blocks(cfg, 3, call)
    calls = cfg["backbone"]["num_hidden_layers"] * K
    got = Cell("w8a8-serve").reader("k4_ms.serve").read(layer)
    assert got == pytest.approx(calls * us / 1e3)


@pytest.mark.parametrize("call,drop", [
    ([(FUSED, 20.0)], 5),                       # a block lacks a call
    ([(SCORES, 8.0), (VALUES, 9.0), (MERGE, 1.5)], 0),
    ([], None),                                 # the masked attention
])
def test_k4_ms_reads_nothing_without_a_call_each_step_and_layer(call, drop):
    layer = _blocks(tiny_config(), 3, call, drop)
    reader = Cell("w8a8-serve").reader("k4_ms.serve")
    assert reader.read(layer) is None
    assert reader.read({}) is None

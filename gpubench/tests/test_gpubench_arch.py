"""What the benchmark reads of `csm-1b-w8a8`, pinned as literals: the
seeded weights' spec, kernel 1's frame bound and launch count, the model's
operations, the reference's logits, and what every per-layer reader returns
for fixed synthetic stretches of the stream and serve cells. The code that
computes them has to give them exactly; a change that moves one changes
what the benchmark reads."""

import hashlib

import numpy as np
import pytest
import torch

from gpubench import roofline, trace, weights
from gpubench.reference.csm import CSMReference, no_tf32
from gpubench.run import Cell
from tiny import tiny_config

SPEC_SHA256 = \
    "af0b3c6f2cde9948a2aed0f822b41cb40bbf1c2da70fb4974399fa5fc4fad0ac"
K1_FRAME = {1: 0.000292365143880597, 64: 0.00031539689074626864}
FRAME_OPS = {40: 9346422784.0, 400: 9393608704.0}
PREFILL_OPS = {48: 93578080256.0, 339: 667309322240.0}
# fp32 on the CPU in one thread: the CPU's BLAS splits its sums by thread
LOGITS_SHA256 = \
    "1bd3e779a57a5d34c7ea46289fa8353136f21c877ba4cada6a24f72deeef79f5"
STREAM_READS = {
    "frame_busy_ms.stream": 0.761,
    "k3_roofline.stream": 54.134333134328365,
    "k1_roofline.stream": 44.567857298871495,
    "mfu.stream": 0.01733472113188479,
    "idle_share.stream": 69.12,
    "frame_idle_ms.stream": 1.7345000000000002}
READS = {
    "w8a8-stream": STREAM_READS,
    "w8a8-voice": STREAM_READS,
    "w8a8-serve": {
        "block_busy_ms.serve": 8.964,
        "slot_use.serve": 78.125,
        "admit_first_chunk_p50_ms.serve": 250.0,
        "k3_roofline.serve": 58.12056659459642,
        "k1_roofline.serve": 48.07879432107754,
        "mfu.serve": 0.01733472113188479,
        "idle_share.serve": 30.961538461538463,
        "admit_issue_ms.serve": 0.03,
        "block_host_ms.serve": 0.029,
        "k4_ms.serve": 0.448}}

MAIN, ENGINE = (1, 1), (1, 7)
LAYERS = 16


def _config() -> dict:
    return Cell("w8a8-stream").config


def test_the_seeded_spec():
    spec = weights.csm_spec(_config())
    assert hashlib.sha256(repr(spec).encode()).hexdigest() == SPEC_SHA256


@pytest.mark.parametrize("rows", sorted(K1_FRAME))
def test_kernel1_frame_bound(rows):
    assert roofline.k1_frame_bound_s(_config(), rows) == (K1_FRAME[rows], 65)


@pytest.mark.parametrize("context", sorted(FRAME_OPS))
def test_frame_ops(context):
    assert roofline.frame_ops(_config(), context) == FRAME_OPS[context]


@pytest.mark.parametrize("rows", sorted(PREFILL_OPS))
def test_prefill_ops(rows):
    assert roofline.prefill_ops(_config(), rows) == PREFILL_OPS[rows]


def reference_logits(cfg: dict) -> torch.Tensor:
    """The reference of a tiny configuration at seed 0 over a 12-row prompt
    (8 text rows, 4 audio rows) and 5 served frames, in one thread: codebook
    0's logits and the decoder's, flattened."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = weights.csm_params(cfg, 0, torch.device("cpu"),
                                    torch.bfloat16)
        ref = CSMReference(params, cfg, bits=8)
        rng = np.random.default_rng(0)
        k, v = cfg["audio_num_codebooks"], cfg["audio_vocab_size"]
        prompt = np.concatenate([rng.integers(0, v, (12, k)), rng.integers(
            0, cfg["text_vocab_size"], (12, 1))], 1)
        mask = np.zeros((12, k + 1), np.int64)
        mask[:8, -1] = 1
        mask[8:, :-1] = 1
        frames = rng.integers(0, v, (5, k))
        with no_tf32():
            c0, dec = ref.logits(prompt, mask, frames, torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    return torch.cat([c0.flatten(), dec.flatten()])


def test_reference_logits():
    got = reference_logits(tiny_config())
    assert got.shape == (5 * 67 + 5 * 7 * 67,)
    assert hashlib.sha256(got.numpy().tobytes()).hexdigest() == LOGITS_SHA256


def _x(cat, name, ts, dur, corr=None, thread=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    if thread is not None:
        e["pid"], e["tid"] = thread
    return e


def stretch(serve: bool, graphs: int = 3) -> trace.Trace:
    """`graphs` replayed graphs (serve: blocks of 8 frames, each layer's
    attention a fused kernel-4 launch; stream: one frame), each launched
    under a span (`engine.block`, `stream.replay`) after an eager kernel
    under another (`engine.admit`; the stream's first `stream.assemble`).
    A frame: each of 16 layers' four kernel-1 launches (9-11 us), the
    projection's (12 us), a row quantization (5 us), kernel 3 (stream 100
    us, serve 400, and the frame's index) and an elementwise kernel (5
    us)."""
    frames = 8 if serve else 1
    gap = 1000.0 + 1500.0 * frames
    thread = ENGINE if serve else MAIN
    ev = [_x("user_annotation", trace.STRETCH, 0.0, gap * graphs)]
    for g in range(graphs):
        t0 = gap * g
        if serve or g == 0:
            ev.append(_x("user_annotation",
                         "engine.admit" if serve else "stream.assemble",
                         t0 + 10, 30.0, thread=thread))
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", t0 + 20, 1.0,
                     1000 + g, thread))
        ev.append(_x("kernel", "elementwise_kernel", t0 + 25, 10.0 + g,
                     1000 + g))
        ev.append(_x("user_annotation",
                     "engine.block" if serve else "stream.replay",
                     t0 + 50, 10.0, thread=thread))
        ev.append(_x("cuda_runtime", "cudaGraphLaunch", t0 + 55, 1.0, g + 1,
                     thread))
        t = t0 + 100.0 + 7.0 * g
        kernels = []
        for f in range(frames):
            for layer in range(LAYERS):
                kernels += [("w8a8_matvec_kernel", 9.0 + (j + layer) % 3)
                            for j in range(4)]
                if serve:
                    kernels.append(("flash_decode_kernel", 3.0 + layer % 2))
            kernels += [("w8a8_matvec_kernel", 12.0),
                        ("quant_rows_kernel", 5.0),
                        ("resident_frame_kernel",
                         (400.0 if serve else 100.0) + f),
                        ("elementwise_kernel", 5.0)]
        for name, d in kernels:
            ev.append(_x("kernel", name, t, d, g + 1))
            t += d
    return trace.Trace(ev)


def layer_of(cell: str) -> dict:
    """What a driver of `cell` hands the readers over `stretch`."""
    serve = cell == "w8a8-serve"
    layer = dict(trace=stretch(serve), config=_config(), span_s=0.25,
                 requests=[dict(rows=20, prefill=True, frames=[0, 1, 2]),
                           dict(rows=339, prefill=False, frames=[5, 6])])
    if serve:
        layer.update(rows=64, counts=None,
                     engine_counts=dict(steps=10, frames_emitted=4000,
                                        frames_per_step=8, n_slots=64),
                     admit_to_first_ms=[300.0, 100.0, 250.0])
    else:
        layer.update(rows=1, counts={"w8a8_matvec": 3 * 65,
                                     "resident_decode_frame": 3})
    return layer


@pytest.mark.parametrize("cell", sorted(READS))
def test_what_every_reader_returns(cell):
    c = Cell(cell)
    layer = layer_of(cell)
    got = {m["name"]: c.reader(m["name"]).read(layer)
           for m in c.per_layer()}
    assert got == READS[cell]

"""Cells, configurations, traffic mixes, drivers, per-layer readers and
backbone architectures are found by name, and a cell or an architecture
added as files alone is picked up and obeyed."""

import hashlib
import json
import os
import re
import shutil

import pytest

from gpubench import arch, run
from tiny import tiny_config

BENCH = os.path.join(run.ROOT, "BENCHMARK.json")


def _bench():
    with open(BENCH) as fh:
        return json.load(fh)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves(cell):
    c = run.Cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert os.path.exists(c.driver_path)
    assert c.cell["config"] == c.entry["config"]
    assert c.cell["traffic"] == c.entry["traffic"]
    assert set(c.cell["limits"]) == {"token_gap", "audio_err"}
    names = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in names and len(names) >= 2
    layer = c.per_layer()
    assert layer
    for m in layer:
        assert m["moves"] in names
        assert callable(c.reader(m["name"]).read)


def test_every_metric_has_a_reader_and_a_cell():
    bench = _bench()
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(run.HERE, "metrics",
                                           f"{m['name']}.py"))
        assert set(m["workloads"]) <= cells
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))


def test_a_cell_added_as_files_is_found(tmp_path):
    """A copy of the checkout's benchmark with one more cell, made of a
    traffic file, a cell file and a BENCHMARK.json entry only."""
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    bench["workloads"].append({
        "name": "w8a8-stream-long", "config": "csm-1b-w8a8",
        "traffic": "voice-app-long", "chips": 1, "why": "longer sentences"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((root / "gpubench" / "traffic" /
                      "voice-app-sentences.json").read_text())
    mix["frames"] = {"dist": "uniform", "lo": 30, "hi": 90}
    (root / "gpubench" / "traffic" / "voice-app-long.json").write_text(
        json.dumps(mix))
    cell = json.loads((root / "gpubench" / "workloads" /
                       "w8a8-stream.json").read_text())
    cell["traffic"] = "voice-app-long"
    (root / "gpubench" / "workloads" / "w8a8-stream-long.json").write_text(
        json.dumps(cell))
    c = run.Cell("w8a8-stream-long", root=str(root))
    assert c.mix["frames"]["hi"] == 90
    assert c.driver_path.endswith(os.path.join("drivers", "stream.py"))
    assert {m["name"] for m in c.end_to_end()} >= {"rtf", "setup_s"}
    # per-layer metrics listed for a cell by name are not reported in a
    # new cell until its entry names it
    assert all("w8a8-stream-long" not in m["workloads"]
               for m in c.per_layer())


def test_an_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.Cell("no-such-cell")


_RECORDER = '''"""The Llama stack, every call recorded in CALLS."""
from gpubench.arch import llama

CALLS = []


def _recorded(name):
    def call(*args, **kwargs):
        CALLS.append(name)
        return getattr(llama, name)(*args, **kwargs)
    return call


spec = _recorded("spec")
port_config = _recorded("port_config")
reference = _recorded("reference")
linears = _recorded("linears")
attention_layers = _recorded("attention_layers")
decode_ops = _recorded("decode_ops")
prefill_ops = _recorded("prefill_ops")
'''

_HYBRID = '''"""A toy hybrid: `layer_types` of "mixer" (three linears, no KV
cache, no attention) and "attention" (a Llama layer)."""
from gpubench.arch import llama


def linears(cfg):
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    attention = llama.linears(dict(cfg, num_hidden_layers=1))[0]
    mixer = [("in", d, 2 * d + 2 * f), ("out", d, d), ("down", f, d)]
    return [attention if t == "attention" else mixer
            for t in cfg["layer_types"]]


def attention_layers(cfg):
    return cfg["layer_types"].count("attention")


def _linear_ops(cfg):
    return 2.0 * sum(i * o for layer in linears(cfg) for _, i, o in layer)


def _attn_ops(cfg, keys):
    return 4.0 * attention_layers(cfg) * cfg["num_attention_heads"] \\
        * cfg["head_dim"] * keys


def decode_ops(cfg, context):
    return _linear_ops(cfg) + _attn_ops(cfg, context)


def prefill_ops(cfg, rows):
    return rows * _linear_ops(cfg) + _attn_ops(cfg, rows * (rows + 1) / 2)
'''


def _with_arch(tmp_path, monkeypatch, name: str, source: str) -> dict:
    """A copy of the checkout's benchmark with one more backbone
    architecture, `arch/<name>.py`, the harness looking there; the tiny
    configuration with its backbone's `arch` set to it."""
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "gpubench" / "arch" / f"{name}.py").write_text(source)
    monkeypatch.setattr(arch, "HERE", str(root / "gpubench" / "arch"))
    cfg = tiny_config()
    cfg["backbone"]["arch"] = name
    return cfg


def test_an_arch_added_as_files_is_obeyed_everywhere(tmp_path, monkeypatch):
    """Every site that touches the backbone goes through the file the
    configuration names, and over a file that delegates to `llama` gives
    what `llama` gives."""
    import torch

    from gpubench import metrics_common, roofline, system, weights
    from gpubench.reference.csm import CSMReference

    from test_gpubench_arch import reference_logits
    from test_gpubench_k4 import FUSED, _blocks

    cfg = _with_arch(tmp_path, monkeypatch, "recorder", _RECORDER)
    plain = tiny_config()
    calls = arch.load(cfg).CALLS

    def through(*names):
        got = set(calls)
        calls.clear()
        return got >= set(names)

    assert weights.csm_spec(cfg) == weights.csm_spec(plain)
    assert through("spec")
    args = system.model_args(cfg)
    assert through("port_config")
    from csm_mlx_tpu_torch.config import BACKBONE_CONFIGURATION

    assert BACKBONE_CONFIGURATION[args.backbone_name] \
        == arch.llama.port_config(plain["backbone"])
    params = weights.csm_params(cfg, 0, torch.device("cpu"), torch.bfloat16)
    CSMReference(params, cfg)
    assert through("reference")
    assert roofline.k1_frame_bound_s(cfg, 64) \
        == roofline.k1_frame_bound_s(plain, 64)
    assert roofline.frame_ops(cfg, 40) == roofline.frame_ops(plain, 40)
    assert roofline.prefill_ops(cfg, 48) == roofline.prefill_ops(plain, 48)
    assert through("linears", "decode_ops", "prefill_ops")
    layer = _blocks(cfg, 2, [(FUSED, 20.0)])
    assert len(metrics_common.replays(layer)) == 2
    assert through("linears")
    assert run.Cell("w8a8-serve").reader("k4_ms.serve").read(layer) \
        is not None
    assert through("attention_layers")
    # the reference's logits through the file are the ones pinned for llama
    from test_gpubench_arch import LOGITS_SHA256

    got = reference_logits(cfg)
    assert hashlib.sha256(got.numpy().tobytes()).hexdigest() == LOGITS_SHA256


K = 8
HYBRID_TYPES = ["mixer", "attention", "mixer", "mixer"]


def _hybrid_blocks(cfg: dict, n: int, k4_layers):
    """`n` replayed blocks of K frames at 64 rows: in each frame every
    layer's kernel-1 launches (10 us) and, in the layers `k4_layers`, a
    kernel-4 call (20 us); the projection's kernel-1 launch, kernel 3 and
    an elementwise kernel."""
    from gpubench import trace

    per_layer = [len(layer) for layer in arch.load(cfg).linears(
        cfg["backbone"])]
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
           "ts": 0.0, "dur": 1e5 * n}]
    for g in range(n):
        t = 1e5 * g
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaGraphLaunch", "ts": t, "dur": 5.0,
                   "args": {"correlation": g + 1}})
        kernels = []
        for _ in range(K):
            for i, launches in enumerate(per_layer):
                kernels += [("w8a8_matvec_kernel", 10.0)] * launches
                if i in k4_layers:
                    kernels.append(("flash_decode_kernel", 20.0))
            kernels += [("w8a8_matvec_kernel", 10.0),
                        ("resident_frame_kernel", 100.0),
                        ("elementwise_kernel", 5.0)]
        t += 50.0
        for name, d in kernels:
            ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": t,
                       "dur": d, "args": {"correlation": g + 1}})
            t += d
    return dict(trace=trace.Trace(ev), rows=64, config=cfg, counts=None)


def test_a_hybrid_arch_is_counted_by_its_layers(tmp_path, monkeypatch):
    """Two kinds of layer with different linears, one of four holding a KV
    cache: kernel 1's launches and bound, the replays, kernel 4's calls
    and the model's operations follow the file's layers."""
    from gpubench import metrics_common, roofline

    cfg = _with_arch(tmp_path, monkeypatch, "hybrid", _HYBRID)
    b = cfg["backbone"]
    b.update(num_hidden_layers=4, layer_types=HYBRID_TYPES)
    hybrid = arch.load(cfg)
    layers = hybrid.linears(b)
    assert [len(layer) for layer in layers] == [3, 4, 3, 3]
    bound, launches = roofline.k1_frame_bound_s(cfg, 64)
    assert launches == 3 + 4 + 3 + 3 + 1
    assert bound == pytest.approx(
        sum(roofline.k1_bound_s(64, i, o) for layer in layers
            for _, i, o in layer)
        + roofline.k1_bound_s(128, b["hidden_size"],
                              cfg["decoder"]["hidden_size"]))

    reader = run.Cell("w8a8-serve").reader("k4_ms.serve")
    attending = [i for i, t in enumerate(HYBRID_TYPES) if t == "attention"]
    layer = _hybrid_blocks(cfg, 3, attending)
    assert [n for _, n in metrics_common.replays(layer)] == [K] * 3
    assert reader.read(layer) == pytest.approx(
        hybrid.attention_layers(b) * K * 20.0 / 1e3)
    # a kernel-4 call in every layer is num_hidden_layers x frames: not
    # this backbone's
    assert reader.read(_hybrid_blocks(cfg, 3, range(4))) is None
    # Llama's launches a frame are not this backbone's frame
    llama_layer = _hybrid_blocks(tiny_config(), 3, range(2))
    llama_layer["config"] = cfg
    assert metrics_common.replays(llama_layer) == []

    plain = tiny_config()
    for context in (40, 400):
        decoder_part = roofline.frame_ops(plain, context) \
            - arch.llama.decode_ops(plain["backbone"], context)
        assert roofline.frame_ops(cfg, context) \
            == hybrid.decode_ops(b, context) + decoder_part
    head = 2.0 * b["hidden_size"] * cfg["audio_vocab_size"]
    assert roofline.prefill_ops(cfg, 48) == hybrid.prefill_ops(b, 48) + head


def test_an_unknown_arch_is_refused_before_any_weight(tmp_path):
    from gpubench import system, weights

    cfg = tiny_config()
    cfg["backbone"]["arch"] = "no-such-arch"
    want = os.path.join("arch", "no-such-arch.py")
    for call in (lambda: arch.load(cfg), lambda: weights.csm_spec(cfg),
                 lambda: system.model_args(cfg),
                 lambda: system.build_csm(cfg, 0, "no device")):
        with pytest.raises(SystemExit, match=re.escape(want)):
            call()


def test_llama_refuses_a_key_it_does_not_know():
    cfg = tiny_config()["backbone"]
    arch.llama.port_config(dict(cfg, arch="llama"))
    with pytest.raises(SystemExit, match="layer_types"):
        arch.llama.port_config(dict(cfg, layer_types=["mamba"]))

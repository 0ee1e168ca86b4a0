"""The drivers run on the CPU at a tiny size, without the harness's look
for a chip: the system against the reference (`correct` true), the
control and each fault the cells can have (`correct` false), and what a
run leaves in `sys.modules`."""

import ast
import contextlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench import checks, run
from tiny import Ctx, tiny_config

SEED = 2 ** 31 + 12345
CELLS = ("w8a8-stream", "w8a8-serve", "w8a8-voice")
# seconds a test's window lasts: enough finished requests on the CPU
SECONDS = {"w8a8-stream": 2.0, "w8a8-serve": 4.0, "w8a8-voice": 6.0}


def _ctx(cell_name: str, seconds: float, control: bool = False) -> Ctx:
    c = run.Cell(cell_name)
    cell, mix = dict(c.cell), dict(c.mix)
    # every request greedy, so that every one can be compared
    mix["greedy_share"] = 1.0
    if c.cell["driver"] == "engine":
        # 4 slots, shorter requests: a few blocks on the CPU
        mix.update(clients=4, frames=dict(mix["frames"], hi=40))
        cell.update(engine=dict(cell["engine"], n_slots=4),
                    warmup=dict(min_s=0.5, stable_blocks=2, max_s=30))
    return Ctx(cell, mix, tiny_config(), SEED, seconds, control)


def _run(cell_name: str, seconds: float = None, control: bool = False):
    seconds = SECONDS[cell_name] if seconds is None else seconds
    ctx = _ctx(cell_name, seconds, control)
    driver = run.load_module(
        os.path.join(run.HERE, "drivers", f"{ctx.cell['driver']}.py"),
        f"gpubench_test_driver_{ctx.cell['driver']}")
    torch.manual_seed(0)
    res = driver.run(ctx)
    cell = run.Cell(cell_name)
    verdict = run.judge(cell, res["readings"])
    correct = all(v is not None and lim is not None and v <= lim
                  for _, v, lim in verdict) and res["failed"] == 0
    return res, correct


@pytest.mark.parametrize("cell", CELLS)
def test_system_matches_reference(cell):
    res, correct = _run(cell)
    r = res["readings"]
    assert res["attempted"] > 0 and r["requests"] > 0 and r["tokens"] > 0
    assert correct, r
    assert res["e2e"]["rtf"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference at int4 in the system's place reads many times the
    token gap the system reads. (The limits are set for the cell's own
    size, where the control reads 2.6-3.8 against a limit of 1.2; at this
    size, 2 layers a stack, it reads 0.9-1.6. TF32 does not exist on the
    CPU: the codec's control is read on the card only,
    `test_control_on_the_card`.)"""
    res, _ = _run(cell, control=True)
    r = res["readings"]
    assert r["control_token_gap"] > 5 * r["token_gap"], r


@contextlib.contextmanager
def _token_altered():
    """Codebook 0 of every frame moved, where the sampler produces it, to
    the token its logits rank last."""
    from csm_mlx_tpu_torch.ops.sampling import SamplerConfig

    real = SamplerConfig.__call__

    def worst(self, generator, logits):
        real(self, generator, logits)
        return torch.argmin(logits.float(), dim=-1)

    SamplerConfig.__call__ = worst
    try:
        yield
    finally:
        SamplerConfig.__call__ = real


@contextlib.contextmanager
def _audio_altered():
    """The codec's decode step returns its audio 1% louder."""
    from csm_mlx_tpu_torch.models.mimi import mimi as mimi_mod

    real = mimi_mod.mimi_decode_step_fn

    def louder(*a, **kw):
        audio, state = real(*a, **kw)
        return audio * 1.01, state

    mimi_mod.mimi_decode_step_fn = louder
    try:
        yield
    finally:
        mimi_mod.mimi_decode_step_fn = real


@contextlib.contextmanager
def _state_unchanged():
    """A step that returns its state unchanged: the frame step and the
    engine's block leave their frame, cache and audio buffers as they were
    (the prefill and the first frame still run)."""
    from csm_mlx_tpu_torch import continuous, generation

    real = generation.FrameStep._step, continuous.ContinuousEngine._block
    generation.FrameStep._step = lambda self: None
    continuous.ContinuousEngine._block = lambda self, cache, marks=None: None
    try:
        yield
    finally:
        generation.FrameStep._step, continuous.ContinuousEngine._block = real


@pytest.mark.parametrize("fault", [_token_altered, _audio_altered,
                                   _state_unchanged])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(cell, fault):
    with fault():
        res, correct = _run(cell)
    assert not correct, res["readings"]


def test_sample_keeps_the_longest():
    served = [dict(greedy=True, frames=np.zeros((n, 8))) for n in
              (5, 30, 7, 9, 11, 2)] + [dict(greedy=False,
                                            frames=np.zeros((99, 8)))]
    picked = checks.sample(served, 3, 3)
    assert len(picked) == 3 and len(picked[0]["frames"]) == 30
    assert all(p["greedy"] for p in picked)


def test_sample_keeps_a_context_request():
    """Where the seed's draw holds no request with conversational context,
    one is put in place of the last drawn; the longest stays first."""
    served = [dict(greedy=True, context=False, frames=np.zeros((n, 8)))
              for n in range(5, 45)]
    served[3]["context"] = True
    for seed in range(20):
        picked = checks.sample(served, seed, 4)
        assert len(picked) == 4 and len(picked[0]["frames"]) == 44
        assert any(p["context"] for p in picked)
    plain = [dict(r, context=False) for r in served]
    assert len(checks.sample(plain, 1, 4)) == 4


_STUB_READER = """import sys
import types


def read(layer):
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return 1.0
"""

_MAIN_WITH_A_STUB_CARD = """import sys
sys.path.insert(0, %r)
import torch
from gpubench import run
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.get_device_name = lambda i=0: "stub"
run.run_cell = lambda *a, **kw: dict(
    readings={"token_gap": 0.1, "audio_err": 0.0, "requests": 1,
              "tokens": 8},
    failed=0, attempted=1, layer={}, memory_peak_bytes=0, e2e={},
    setup_s=1.0)
sys.exit(run.main(["--workload", "w8a8-stream", "--seed", "1",
                   "--seconds", "1", "--trace", "1"]))
"""


@pytest.mark.parametrize("loads_jax", [True, False])
def test_a_reader_that_loads_jax_refuses_the_run(tmp_path, loads_jax):
    """A per-layer reader that loads `jax` (a stub module) after the window:
    the run prints no result and exits nonzero. The same run with a reader
    that loads nothing prints its line."""
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["per_layer"].append({
        "name": "stub.stream", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "stub", "moves": "rtf",
        "workloads": ["w8a8-stream"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    stub = _STUB_READER if loads_jax else "def read(layer):\n    return 1.0\n"
    (root / "gpubench" / "metrics" / "stub.stream.py").write_text(stub)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", _MAIN_WITH_A_STUB_CARD % str(root)],
        capture_output=True, text=True, timeout=120, env=env, cwd=root)
    if loads_jax:
        assert out.returncode != 0 and out.stdout.strip() == "", out.stdout
        assert "jax" in out.stderr.strip().splitlines()[-1]
    else:
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["metrics"] == {"stub.stream": {"value": 1.0,
                                                   "unit": "%"}}


def test_a_run_loads_no_jax(tmp_path):
    """A tiny stream run in a fresh process, then the harness's own look at
    sys.modules by whole top-level names."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import test_gpubench_run as t\n"
        "t._run('w8a8-stream', 0.5)\n"
        "from gpubench.run import forbidden_modules\n"
        "print('FORBIDDEN', forbidden_modules(), "
        "'csm_mlx_tpu_torch' in sys.modules)\n"
        % (run.ROOT, os.path.dirname(__file__)))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN [] True" in out.stdout


def test_forbidden_names_are_whole_top_level_names():
    mods = dict(sys.modules)
    try:
        sys.modules["csm_mlx_tpu_torch_extra"] = sys
        sys.modules["jaxlibrary"] = sys
        assert "jax" not in run.forbidden_modules()
        sys.modules["csm_mlx_tpu.models"] = sys
        assert "csm_mlx_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def _files():
    for d, _, names in os.walk(run.HERE):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


@pytest.mark.parametrize("path", sorted(_files()),
                         ids=lambda p: os.path.relpath(p, run.HERE))
def test_no_file_imports_jax(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    tops = {n.split(".")[0] for n in names}
    assert not tops & set(run.FORBIDDEN), tops
    if "reference" in os.path.relpath(path, run.HERE).split(os.sep):
        assert "csm_mlx_tpu_torch" not in tops


def test_the_harness_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
         "w8a8-stream", "--seed", str(SEED), "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120, cwd=run.ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, cuda_device, tmp_path):
    """One short run of the cell through the command, on the card: a
    result line, correct."""
    out = subprocess.run(
        [sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
         cell, "--seed", "4000000123", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell, cuda_device):
    """At the cell's own size on the card: the reference one precision
    lower in the system's place (int4 weights; TF32 in the codec) fails
    both limits, and the system passes them."""
    c = run.Cell(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = run.run_cell(c, 4000000321, 10.0, False, cuda_device,
                       control=True)
    r, lim = res["readings"], c.cell["limits"]
    for name in ("token_gap", "audio_err"):
        assert r[name] <= lim[name] < r[f"control_{name}"], r

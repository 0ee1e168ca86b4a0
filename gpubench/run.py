"""Run one benchmark cell once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is found by name: its entry in
`BENCHMARK.json`, its file `gpubench/workloads/<cell>.json` (configuration,
traffic mix, driver, limits), `gpubench/configs/<config>.json`,
`gpubench/traffic/<traffic>.json` and `gpubench/drivers/<driver>.py`. With
`--trace 0` the result's metrics are the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, each read by
`gpubench/metrics/<metric>.py` from a traced stretch of the window.

The last lines on standard error, and the `checks` key that comes last in
the result, give each number compared with its limit. Exits nonzero, and
prints no result, without enough CUDA devices, or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "csm_mlx_tpu")
WATCHDOG_S = 330


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """Everything the harness finds by a cell's name."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        self.here = here = os.path.join(root, os.path.basename(HERE))
        self.bench = load_json(root, "BENCHMARK.json")
        entry = [w for w in self.bench["workloads"] if w["name"] == name]
        if not entry:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entry[0]
        self.name = name
        self.cell = load_json(here, "workloads", f"{name}.json")
        self.config = load_json(here, "configs",
                                f"{self.entry['config']}.json")
        self.mix = load_json(here, "traffic", f"{self.entry['traffic']}.json")
        self.driver_path = os.path.join(here, "drivers",
                                        f"{self.cell['driver']}.py")

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        e2e = {m["name"] for m in self.end_to_end()}

        def reports(m: dict) -> bool:
            if "workloads" in m:
                return self.name in m["workloads"]
            return m["moves"] in e2e

        return [m for m in self.bench["per_layer"] if reports(m)]

    def reader(self, metric: str):
        return load_module(os.path.join(self.here, "metrics",
                                        f"{metric}.py"),
                           f"gpubench_metric_{metric.replace('.', '_')}")


class Context:
    """What a driver is handed: the cell's files, the run's arguments, and
    the harness's helpers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, control: bool = False):
        self.cell, self.config, self.mix = cell.cell, cell.config, cell.mix
        self.name = cell.name
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.control = device, control
        self.t_start = T_START
        self.log = log

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> float:
        import torch

        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        return time.perf_counter() - self.t_start

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @staticmethod
    def quantile(values, q: float):
        import numpy as np

        return float(np.percentile(np.asarray(values, np.float64), 100 * q)) \
            if len(values) else None


def judge(cell: Cell, readings: dict) -> list:
    """(name, value, limit) of each compared number; a number with no limit
    or no value fails."""
    out = []
    for name, limit in cell.cell["limits"].items():
        out.append((name, readings.get(name), limit))
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False) -> dict:
    driver = load_module(cell.driver_path,
                         f"gpubench_driver_{cell.cell['driver']}")
    ctx = Context(cell, seed, seconds, trace, device, control)
    return driver.run(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = Cell(args.workload)
    # a run that has not ended by then prints every thread's stack and
    # exits nonzero: a run must end within 360 s
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" visible")
        return 2
    # the configuration's fp32 (the codec, the reference) is fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = result_line(cell, res, bool(args.trace), dev)
    # the last look, after every reader has run: nothing of JAX loaded
    bad = forbidden_modules()
    if bad:
        log(f"refused: the run loaded {bad}")
        return 3
    print(json.dumps(line), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


def result_line(cell: Cell, res: dict, trace: bool, dev: dict) -> dict:
    """The result line of a driver's run: the cell's end-to-end metrics, or
    with `trace` its per-layer metrics, each read by its reader; the
    compared numbers, also logged as the last lines on standard error."""
    checks = judge(cell, res["readings"])
    correct = all(v is not None and lim is not None and v <= lim
                  for _, v, lim in checks) and res["failed"] == 0
    metrics = {}
    layer = res["layer"]
    if trace:
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        for m in cell.end_to_end():
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    tr = layer.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_us(tr.kernels) / 1e6
        dev["window_s"] = tr.window_us / 1e6
        line["breakdown"] = tr.breakdown()
        log(f"[trace] {len(tr.kernels)} device events, "
            f"{len(tr.graph_launches)} graph launches, busy "
            f"{dev['busy_s']:.4f} s of {dev['window_s']:.4f} s")
    r = res["readings"]
    log(f"compared over {r.get('requests')} requests, {r.get('tokens')} "
        f"tokens")
    for name, value, limit in checks:
        log(f"check {name}: {value!r} (limit {limit!r})")
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checks}
    return line


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of `correct` are set from (not run by the
benchmark's runs).

    python3 gpubench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, in one process: the cell's driver runs as a benchmark run
does, with a window of `--seconds` (long enough to finish the mix's longest
requests and to compare as many as a run does), and its compared numbers
are read for the system and for the control: the reference put in the
system's place one precision lower (`checks.readings(control=True)`).
Prints one JSON line per seed and, last, the largest reading of the system
and the smallest of the control for each number.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from gpubench.run import Cell, log, run_cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run_cell(cell, seed, args.seconds, False, device, control=True)
        r = dict(res["readings"], seed=seed, attempted=res["attempted"],
                 failed=res["failed"], seconds=time.perf_counter() - t0)
        rows.append(r)
        print(json.dumps(r), flush=True)
        del res
        torch.cuda.empty_cache()
    summary = {}
    for name in cell.cell["limits"]:
        prog = [r[name] for r in rows if r.get(name) is not None]
        ctl = [r[f"control_{name}"] for r in rows
               if r.get(f"control_{name}") is not None]
        summary[name] = {"system_max": max(prog) if prog else None,
                         "control_min": min(ctl) if ctl else None}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

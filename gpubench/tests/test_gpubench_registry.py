"""Cells, configurations, traffic mixes, drivers and per-layer readers are
found by name, and a cell added as files alone is picked up."""

import json
import os
import shutil

import pytest

from gpubench import run

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

"""The harness finds every piece by its file name, and a cell added as
files alone runs."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench import harness

CELLS = ["mlp_v1.train_b32768", "unet_v5.serve_c8", "unet_v5.train_b8192"]


def test_names_come_from_the_files():
    assert harness.names("workloads") == CELLS
    assert harness.names("configs") == ["mlp_v1", "unet_v5"]
    assert harness.names("mixes") == ["serve_c8", "train_b32768",
                                      "train_b8192"]
    assert harness.names("drivers") == ["serve", "train"]
    assert harness.names("reference") == ["common", "mlp_v1", "unet_v5"]
    assert set(harness.names("metrics")) == {
        "rows_per_call.serve", "device_call_p95_ms.serve", "mfu.serve",
        "mfu.train", "k5_roofline.serve", "k5bwd_roofline.train",
        "device_idle_pct.train", "device_idle_pct.serve", "peak_gib.train",
        "round_trip_p95_ms.serve", "queue_wait_p95_ms.serve",
        "idle_in_server_pct.serve", "forward_ms.train", "backward_ms.train",
        "optimizer_ms.train"}


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_resolves(name):
    cell = harness.Cell(name)
    assert cell.config["name"] == cell.spec["config"]
    assert hasattr(cell.driver, "run") and hasattr(cell.reference, "train")
    assert cell.spec["chips"] == 1 and cell.spec["trace"]["seconds"] > 0


@pytest.mark.parametrize("name", sorted(harness.names("metrics")))
def test_each_reader_has_a_unit_and_reads_nothing_from_nothing(name):
    mod = harness.load_module("metrics", name)
    assert isinstance(mod.UNIT, str) and mod.UNIT
    assert mod.read({"kind": "neither"}) is None


def test_the_benchmark_file_names_every_cell_and_metric():
    with open(harness.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    assert sorted(w["name"] for w in bench["workloads"]) == CELLS
    for w in bench["workloads"]:
        spec = harness.load_json("workloads", w["name"])
        assert (w["config"], w["traffic"], w["chips"]) == (
            spec["config"], spec["traffic"], spec["chips"])
    assert {m["name"] for m in bench["per_layer"]} == set(
        harness.names("metrics"))
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"


NEW_FILES = {
    "workloads/mlp_tiny.train_b256.json": {
        "config": "mlp_tiny", "traffic": "train_b256", "chips": 1,
        "why": "a cell added as files", "trace": {"start_s": 1, "seconds": 1},
        "limits": {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0,
                   "batch_rows_foreign": 0}},
    "traffic/mixes/train_b256.json": {
        "driver": "train", "batch": 256, "pool_batches": 3,
        "block_shuffle": 16, "warm_epochs": 1, "follow": 3},
}
NEW_METRIC = '''
UNIT = "steps"


def read(data):
    return data["samples"] / data["batch"] if data.get("kind") == "train" \\
        else None
'''


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    to a copy of the benchmark as new files, no file edited: the cell
    runs on the CPU and its new metric is read."""
    src = harness.HERE
    dst = tmp_path / "portbench"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "_cache"))
    before = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    cfg = json.loads((src / "configs" / "mlp_v1.json").read_text())
    cfg.update(name="mlp_tiny", model={"hidden": [32, 16]})
    files = dict(NEW_FILES, **{"configs/mlp_tiny.json": cfg})
    for rel, obj in files.items():
        (dst / rel).write_text(json.dumps(obj))
    shutil.copy(src / "reference" / "mlp_v1.py",
                dst / "reference" / "mlp_tiny.py")
    (dst / "metrics" / "steps_in_window.train.py").write_text(NEW_METRIC)
    assert all(p.read_bytes() == b for p, b in before.items())
    # the checkout's program beside the copy (the norms it reads)
    (tmp_path / "climsim_tpu_torch").symlink_to(
        harness.ROOT / "climsim_tpu_torch")
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(tmp_path)!r}]
        from portbench import harness
        from portbench.run import Context, per_layer
        assert harness.HERE.parent == __import__("pathlib").Path(
            {str(tmp_path)!r})
        cell = harness.Cell("mlp_tiny.train_b256")
        res = cell.driver.run(Context(cell, 11, 1.0, False, device="cpu",
                                      t_process=time.perf_counter()))
        print(json.dumps({{"correct": res["correct"],
                          "metrics": sorted(res["end_to_end"]),
                          "layer": per_layer(res["data"])}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"] == ["setup_s", "train_samples_per_s"]
    assert res["layer"]["steps_in_window.train"]["value"] >= 3


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}"
UNIT = r"[A-Za-z0-9_/%.-]{1,16}"


def test_the_benchmark_file_keeps_its_format():
    import re

    with open(harness.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.fullmatch(NAME, c["name"]) and line(c["why"])
        assert line(c["source"]) and c["file"].startswith("portbench/")
    cells = {}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.fullmatch(NAME, w["name"]) and line(w["why"])
        assert re.fullmatch(NAME, w["traffic"]) and w["chips"] in (1, 4)
        cells[w["name"]] = set()
    e2e = {}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert re.fullmatch(NAME, m["name"]) and re.fullmatch(UNIT, m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for w in m.get("workloads", cells):
            cells[w].add(m["name"])
        e2e[m["name"]] = m
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert all(len(v) >= 2 for v in cells.values())
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert re.fullmatch(NAME, m["name"]) and re.fullmatch(UNIT, m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        assert all(m["moves"] in cells[w] for w in m["workloads"])

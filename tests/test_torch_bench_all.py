"""The port's measured-epoch harness (``climsim_tpu_torch.bench_all``) and
ingest benchmark (``climsim_tpu_torch.bench_ingest``) on the CPU.

bench_all runs its rows here at tiny widths and a BENCH_EPOCH_ROWS of a
few batches: the rows' fields (MFU against the peak of the products'
dtype, no north-star ratio), the FLOP count against the analytic one,
the --prior merge and --jsonl streaming as tests/test_bench_harness.py
checks them on the JAX script (its retry test has no counterpart: a
failing model fails the port's run).  bench_ingest's JSON line against
the JAX script's at --pairs 3, and the package's copy of the synthetic
netCDF builder against tests/synthnc.py."""

import functools
import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from climsim_tpu_torch import bench_all as PB
from climsim_tpu_torch import bench_ingest as PBI
from climsim_tpu_torch.data import synthnc as PSYN
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.models.common import Dense
from climsim_tpu_torch.train import recipes as PR
from climsim_tpu_torch.train import rpn_recipe as PRR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import bench_ingest as JBI  # noqa: E402  scripts/
import synthnc as TSYN  # noqa: E402  tests/

HIDDEN = (16, 8)
BATCH, POOL = 64, 256


def _tiny_mlp(s, st, sb, r, device):
    return PR.mlp_trainer(s, st, sb, r, hidden=HIDDEN, steps_per_epoch=10,
                          device=device)


@pytest.fixture
def tiny(monkeypatch):
    """Every row at tiny widths: the MLP and ED at BATCH rows from a
    POOL-row pool, the RPN with 2 members of 32 rows."""
    monkeypatch.setitem(PB.CONFIGS, "MLP",
                        (_tiny_mlp, "v1", BATCH, POOL, "MLP"))
    monkeypatch.setitem(PB.CONFIGS, "ED", (
        lambda s, st, sb, r, device: PR.ed_trainer(s, st, sb, r,
                                                   device=device),
        "v1", BATCH, POOL, "ED"))
    monkeypatch.setattr(PB, "RPN_CONFIG", (2, 32, POOL))
    monkeypatch.setattr(PRR, "rpn_trainer", functools.partial(
        PRR.rpn_trainer, hidden=(16,)))
    monkeypatch.setattr(PB, "RPN_WARMUP_STEPS", 1)
    monkeypatch.setenv("BENCH_EPOCH_ROWS", str(3 * BATCH))


def test_rows_on_the_cpu(tiny, tmp_path):
    """MLP, ED and the RPN at a cut epoch: every field of a row, the
    epoch covered (rows >= BENCH_EPOCH_ROWS), the zoo's float32 products
    at the float32 peak, the MLP's FLOPs those of its Dense layers (6 B
    in out, less the first layer's input gradient), no vs_north_star;
    the table written to --out."""
    out, stream = tmp_path / "B.md", tmp_path / "s.jsonl"
    rows = PB.main(["--models", "MLP,ED,RPN", "--out", str(out),
                    "--jsonl", str(stream), "--rpn-batch", "32",
                    "--device", "cpu"])
    assert [r["model"] for r in rows] == ["MLP", "ED", "RPN x2"]
    for r in rows:
        assert set(r) == {
            "model", "s_per_epoch", "wall_s", "rows", "epoch_rows",
            "samples_per_s", "tflops", "mfu", "peak_tflops",
            "flops_by_dtype", "step_flops", "peak_memory_gb", "steps",
            "warmup_steps", "loss", "note"}
        assert r["epoch_rows"] == 3 * BATCH and r["rows"] >= 3 * BATCH
        assert 0 < r["mfu"] and np.isfinite(r["loss"])
        assert r["peak_tflops"] == 67.0 and set(r["flops_by_dtype"]) == {
            "float32"}
        assert r["peak_memory_gb"] is None   # no card
    mlp = rows[0]
    assert mlp["rows"] == 4 * BATCH and mlp["steps"] == 4   # 1 pool epoch
    assert mlp["warmup_steps"] == POOL // BATCH
    assert mlp["step_flops"] == _analytic()
    assert rows[2]["steps"] == 6 and rows[2]["rows"] == 6 * 32
    assert [json.loads(ln)["model"] for ln in open(stream)] == \
        ["MLP", "ED", "RPN x2"]
    text = out.read_text()
    assert "| MLP |" in text and "vs north star" not in text
    assert "Six-baseline total" not in text   # CNN, HSR, cVAE not run


def _tiny():
    from climsim_tpu_torch import get_varspec, load_asset_norms

    spec = get_varspec("v1")
    return spec, _tiny_mlp(spec, load_asset_norms("v1"), None, 0, "cpu")


def _analytic():
    """A train step's products of the tiny MLP: 2 B in out a Dense layer
    forward, as much for dW, and for dx but at the first layer."""
    layers = [m.weight.shape for m in _tiny()[1].model.modules()
              if isinstance(m, Dense)]
    return 6 * BATCH * sum(o * i for o, i in layers) \
        - 2 * BATCH * layers[0][0] * layers[0][1]


def test_mlp_flops_match_its_dense_layers():
    """step_cost's count on a copy of the state is the analytic one; the
    state does not advance."""
    import copy

    import torch

    spec, tr = _tiny()
    xb = torch.zeros(BATCH, spec.input_len)
    yb = torch.zeros(BATCH, spec.output_len)
    probe = copy.deepcopy(tr.state)
    c = PB.step_cost(lambda: tr.train_step(probe, xb, yb))
    assert tr.state.step == 0 and probe.step == 1
    assert c["flops"] == _analytic()
    assert c["peak_flops"] == PB.PEAK_FLOPS["float32"]


def test_peak_of_a_mix_of_dtypes():
    """A step of bf16 and float32 products runs at the peak whose time
    is the sum of each share's time at its own peak."""
    import torch

    a = torch.ones(8, 8)

    def mixed():
        a @ a
        a.bfloat16() @ a.bfloat16()

    c = PB.step_cost(mixed)
    assert c["flops_by_dtype"] == {"float32": 1024, "bfloat16": 1024}
    assert c["peak_flops"] == pytest.approx(
        2048 / (1024 / 67e12 + 1024 / 989e12))


def _row(model, s_per_epoch, **kw):
    base = dict(model=model, s_per_epoch=s_per_epoch, wall_s=s_per_epoch,
                rows=1000, epoch_rows=1000, samples_per_s=1.0, tflops=1.0,
                mfu=0.1, peak_tflops=67.0, peak_memory_gb=1.0, loss=0.5,
                note="prior")
    base.update(kw)
    return base


def test_prior_merge_dedup_and_order(tmp_path):
    """A rerun seeded with --prior keeps the newest row a model and
    renders the canonical order; a prior row of the JAX script (without
    the port's fields) renders too."""
    fresh = tmp_path / "fresh.jsonl"
    with open(fresh, "w") as f:
        for m, s in [("U-Net v5 (128ch)", 500.0), ("MLP", 9.1),
                     ("MLP", 2.3), ("RPN x32", 60.0)]:
            f.write(json.dumps(_row(m, s, note="fresh")) + "\n")
        f.write(json.dumps({"model": "HSR", "s_per_epoch": 1.7,
                            "wall_s": 1.7, "rows": 1000,
                            "samples_per_s": 1.0, "tflops": 1.0, "mfu": 0.1,
                            "vs_north_star": 1.0, "loss": 0.5,
                            "note": "JAX"}) + "\n")
    out = tmp_path / "table.md"
    rows = PB.main(["--models", "", "--out", str(out),
                    "--jsonl", str(tmp_path / "stream.jsonl"),
                    "--prior", str(fresh), "--device", "cpu"])
    assert [r["model"] for r in rows] == ["MLP", "HSR", "RPN x32",
                                          "U-Net v5 (128ch)"]
    txt = out.read_text()
    assert txt.count("| MLP |") == 1 and "| MLP | 2.30 |" in txt
    assert "| HSR | 1.70 |" in txt and "vs north star" not in txt
    assert not (tmp_path / "stream.jsonl").exists()   # nothing measured


def test_jsonl_streaming(tmp_path):
    """report() appends each row to the stream file as it is measured."""
    stream = tmp_path / "stream.jsonl"
    cost = {"flops": 1e12, "peak_flops": 67e12,
            "flops_by_dtype": {"float32": 1e12}}
    r1 = PB.report("MLP", wall=2.0, rows=1000, flops=1e12, loss=0.1,
                   note="n", epoch_rows=1000, cost=cost, jsonl=str(stream))
    r2 = PB.report("ED", wall=1.0, rows=2000, flops=1e12, loss=0.2,
                   note="n", epoch_rows=1000, cost=cost, jsonl=str(stream))
    rows = [json.loads(ln) for ln in open(stream)]
    assert rows == [r1, r2]
    assert r1["s_per_epoch"] == 2.0 and r2["s_per_epoch"] == 0.5
    assert r1["mfu"] == 1e12 / 2.0 / 67e12
    assert r1["peak_tflops"] == 67.0 and "vs_north_star" not in r1


def test_a_failing_model_fails_the_run(tmp_path, monkeypatch):
    """No retry and no moving on: the error of a model leaves main."""
    calls = []

    def fail(name, *a, **k):
        calls.append(name)
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(PB, "bench_generic", fail)
    with pytest.raises(RuntimeError, match="out of memory"):
        PB.main(["--models", "MLP,ED", "--out", str(tmp_path / "t.md"),
                 "--jsonl", str(tmp_path / "s.jsonl"), "--device", "cpu"])
    assert calls == ["MLP"] and not (tmp_path / "t.md").exists()


def test_main_defaults_to_the_card(tiny, tmp_path):
    """Without --device the rows run on the card: without one, torch's
    own error."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        PB.main(["--models", "MLP", "--out", str(tmp_path / "t.md"),
                 "--jsonl", str(tmp_path / "s.jsonl")])


def _last_json(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_bench_ingest_line_matches_the_script():
    """--pairs 3 --workers 0,1: the JSON line has the script's keys, its
    rows the script's modes and worker counts and fields."""
    argv = ["--pairs", "3", "--workers", "0,1"]
    got, want = _last_json(PBI.main, argv), _last_json(JBI.main, argv)
    assert set(got) == set(want)
    assert got["metric"] == want["metric"] == "ingest_pairs_per_s"
    assert [(r["mode"], r["workers"]) for r in got["rows"]] == \
        [(r["mode"], r["workers"]) for r in want["rows"]]
    assert all(set(a) == set(b) for a, b in zip(got["rows"], want["rows"]))
    assert got["gb_per_pair"] == want["gb_per_pair"]
    assert got["host_cores"] == os.cpu_count()
    assert all(r["pairs_per_s"] > 0 for r in got["rows"])


def test_synthnc_copy_equals_the_tests_builder(tmp_path):
    """The package's copy is tests/synthnc.py byte for byte, and its trees
    are file for file the same."""
    with open(PSYN.__file__, "rb") as a, open(TSYN.__file__, "rb") as b:
        assert a.read() == b.read()
    grid = load_default_grid()
    PSYN.make_tree(tmp_path / "p" / "0001-02", grid, nsteps=2, seed=3)
    TSYN.make_tree(tmp_path / "t" / "0001-02", grid, nsteps=2, seed=3)
    names = sorted(os.listdir(tmp_path / "p" / "0001-02"))
    assert names == sorted(os.listdir(tmp_path / "t" / "0001-02"))
    assert len(names) == 4
    for n in names:
        assert (tmp_path / "p" / "0001-02" / n).read_bytes() == \
            (tmp_path / "t" / "0001-02" / n).read_bytes()

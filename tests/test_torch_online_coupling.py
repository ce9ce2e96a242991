"""The port's online coupling entry (python -m
climsim_tpu_torch.online_coupling) on the CPU: train briefly, wrap with
make_wrapper, export, roll out 384 columns, print the online diagnostics
the JAX package's examples/online_coupling.py prints."""

import importlib.util
import os
import re
import sys

import numpy as np
import torch

from climsim_tpu_torch import online_coupling as OC
from climsim_tpu_torch.data.synthetic import synthetic_inputs
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.online.wrapper import load_aot
from climsim_tpu_torch.varspec import get_varspec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _labels(text: str) -> list[str]:
    """Each printed line up to its first number, bracket or colon: what the
    line reports, not its values."""
    return [re.split(r"[-\d\[{(:]", line, maxsplit=1)[0].strip()
            for line in text.strip().splitlines()]


def test_main_end_to_end_and_export(tmp_path, capsys, monkeypatch):
    path = str(tmp_path / "wrapper.pt2")
    out = OC.main(["--steps", "2", "--train-steps", "2", "--device", "cpu",
                   "--export", path])
    printed = capsys.readouterr().out
    assert np.isfinite(out["train_loss"])
    assert np.isfinite(out["t_rmse_vs_persistence"])
    assert np.isfinite(out["t_drift"])
    assert out["water_res_abs_mean"].shape == (2,)
    assert np.isfinite(out["water_res_abs_mean"]).all()
    for d in (out["precip"], out["microphysics"]):
        assert all(np.isfinite(v) for v in d.values())
    assert out["microphysics"]["frac_negative_qn"] == 0.0   # clamped

    # the exported program serves 384 raw v4 columns
    x = synthetic_inputs(get_varspec("v4"), 384, load_default_grid(), seed=5)
    with torch.inference_mode():
        y = load_aot(path)(torch.from_numpy(x))
    assert y.shape == (384, 368) and torch.isfinite(y).all()

    # the same report, line for line, as the JAX package's example
    spec = importlib.util.spec_from_file_location(
        "jax_online_coupling", os.path.join(ROOT, "examples",
                                            "online_coupling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["online_coupling.py", "--steps", "2",
                                      "--train-steps", "2"])
    mod.main()
    want = _labels(capsys.readouterr().out)
    got = [w for w in _labels(printed) if not w.startswith("exported")]
    assert got == want

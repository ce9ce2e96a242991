"""python -m climsim_tpu_torch.quickstart end to end on the CPU, at a
tiny width: a synthetic v1 split through BatchLoader and fit, scored by
offline_score beside the zero and train-mean baselines, figures
written."""

import numpy as np

from climsim_tpu_torch import quickstart


def test_quickstart_end_to_end(tmp_path):
    out = quickstart.main(["--device", "cpu", "--epochs", "2", "--hidden",
                           "32,32", "--rows", "6144", "--batch", "512",
                           "--out-dir", str(tmp_path)])
    rows = out["history"]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
               for r in rows)
    assert rows[1]["train_loss"] < rows[0]["train_loss"]
    assert set(out["tables"]) == {"mlp", "zero", "train_mean"}
    for table in out["tables"].values():
        assert all(np.isfinite(row["MAE"]) for row in table.values())
    assert (tmp_path / "mae.png").exists() and (tmp_path / "r2.png").exists()

"""Normalization statistics, flattened to the feature layout of a VarSpec.

The port's own copy of what it uses of ``climsim_tpu/norms.py``:
``NormStats`` (built from per-variable stats, read from and written to
npz files, and written as the coupling contract's txt files),
``identity_norms``, ``compute_norms_from_data`` with the cloud rates
fitted to the data (``compute_exponential_lambda``) and
``load_asset_norms``, which reads the port's copies of the assets
(``climsim_tpu_torch/assets/norms_<version>.npz``, bit-equal to the JAX
package's; ``tests/test_torch_package.py`` checks it).

The training-space transform is
    x_norm = (x - inp_sub) / inp_div          (input)
    y_norm = y * out_scale                    (target)
with inp_sub = per-feature mean and inp_div = max - min, as the reference
(climsim_utils/data_utils.py:807-809, save_norm :954-988).  The v5
pipeline applies the cloud exponential transform with per-level rate
``lbd_qn`` before normalizing (climsim_datapip.py:102).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .varspec import VarSpec, var_len


@dataclass(frozen=True)
class NormStats:
    inp_sub: np.ndarray    # (input_len,)
    inp_div: np.ndarray    # (input_len,)
    out_scale: np.ndarray  # (output_len,)
    lbd_qn: np.ndarray | None = None  # (60,) cloud exp-transform rate (v5)
    # v4/v2-family separate-cloud rates (climsim_datapip.py:80-81)
    lbd_qc: np.ndarray | None = None  # (60,)
    lbd_qi: np.ndarray | None = None  # (60,)

    def __post_init__(self):
        # zero-range (constant) inputs: a divisor of 1 instead of the
        # reference's inf/nan -> 0 after dividing (data_utils.py:895-897),
        # numerically the same downstream
        div = np.where(self.inp_div == 0.0, 1.0, self.inp_div)
        object.__setattr__(self, "inp_div", div)

    @classmethod
    def from_var_datasets(cls, spec: VarSpec, mean: dict, maxx: dict,
                          minn: dict, scale: dict,
                          lbd_qn: np.ndarray | None = None) -> "NormStats":
        """Per-variable stats (name -> scalar or (60,) array) flattened
        into the spec's feature vectors: sub = mean, div = max - min,
        out_scale = scale (data_utils.save_norm, :954-988).  A scalar of
        a profile variable is broadcast over its levels."""
        def flat(names, table):
            parts = []
            for v in names:
                val = np.asarray(table[v], dtype=np.float64).reshape(-1)
                n = var_len(v)
                if val.size == 1 and n > 1:
                    val = np.full(n, val[0])
                if val.size != n:
                    raise ValueError(f"{v}: stat has size {val.size}, "
                                     f"want {n}")
                parts.append(val)
            return np.concatenate(parts)

        return cls(inp_sub=flat(spec.inputs, mean),
                   inp_div=flat(spec.inputs, maxx) - flat(spec.inputs, minn),
                   out_scale=flat(spec.outputs, scale), lbd_qn=lbd_qn)

    @classmethod
    def from_npz(cls, path: str) -> "NormStats":
        z = np.load(path)

        def opt(k):
            return z[k] if k in z.files else None

        return cls(inp_sub=z["inp_sub"], inp_div=z["inp_div"],
                   out_scale=z["out_scale"], lbd_qn=opt("lbd_qn"),
                   lbd_qc=opt("lbd_qc"), lbd_qi=opt("lbd_qi"))

    def save_npz(self, path: str) -> None:
        kw = dict(inp_sub=self.inp_sub, inp_div=self.inp_div,
                  out_scale=self.out_scale)
        for k in ("lbd_qn", "lbd_qc", "lbd_qi"):
            if getattr(self, k) is not None:
                kw[k] = getattr(self, k)
        np.savez_compressed(path, **kw)

    def save_txt(self, save_dir: str) -> None:
        """Write inp_sub.txt, inp_div.txt and out_scale.txt in the coupling
        contract's comma-separated format (data_utils.py:973-987), and
        lbd_qn.txt where the stats carry the cloud rate (as
        scripts/package_e3sm.py writes it)."""
        os.makedirs(save_dir, exist_ok=True)
        for name in ("inp_sub", "inp_div", "out_scale", "lbd_qn"):
            v = getattr(self, name)
            if v is not None:
                np.savetxt(os.path.join(save_dir, f"{name}.txt"),
                           np.asarray(v).reshape(1, -1), fmt="%.6e",
                           delimiter=",")


def identity_norms(spec: VarSpec) -> NormStats:
    """Stats that leave the data as it is: sub 0, div 1, scale 1, and a
    rate of 1 for each cloud input the spec has."""
    return NormStats(
        inp_sub=np.zeros(spec.input_len),
        inp_div=np.ones(spec.input_len),
        out_scale=np.ones(spec.output_len),
        lbd_qn=np.ones(60) if "state_qn" in spec.inputs else None,
        lbd_qc=np.ones(60) if "state_q0002" in spec.inputs else None,
        lbd_qi=np.ones(60) if "state_q0003" in spec.inputs else None,
    )


def compute_norms_from_data(spec: VarSpec, inputs: np.ndarray,
                            targets: np.ndarray,
                            scale_floor: float = 1e-8,
                            qn_transform: bool = False) -> NormStats:
    """Compute (mean, max-min, 1/std) stats directly from un-normalized data.

    Matches the online norm-generation recipe: input sub/div from per-feature
    mean and range, output scale = 1/std with a lower threshold to avoid
    exploding scales on near-constant outputs (online_testing/
    data_preparation/normalization/{input_scaling,output_scaling}.ipynb).

    ``qn_transform=True`` (pass the training TransformConfig's flag)
    additionally fits the cloud exponential-transform rates.
    """
    sub = inputs.mean(axis=0, dtype=np.float64)
    div = inputs.max(axis=0).astype(np.float64) - inputs.min(axis=0)
    std = targets.std(axis=0, dtype=np.float64)
    if (sub.size, std.size) != (spec.input_len, spec.output_len):
        raise ValueError(f"data of {sub.size} inputs and {std.size} "
                         f"outputs; {spec.name} has {spec.input_len} and "
                         f"{spec.output_len}")
    osc = 1.0 / np.maximum(std, scale_floor)
    # cloud inputs additionally get the exponential-transform rate, and
    # their sub/div are computed in TRANSFORMED space (the chain applies
    # 1-exp(-lambda*q) BEFORE normalizing, climsim_datapip.py:80-102) --
    # so the stats are complete and chain-consistent for any spec
    # (make_input_transform fails loud on a missing lambda)
    lbds = {}
    for name, field in (("state_qn", "lbd_qn"), ("state_q0002", "lbd_qc"),
                        ("state_q0003", "lbd_qi")):
        sl = spec.input_slices.get(name)
        if sl is None or not qn_transform:
            continue
        q = inputs[:, sl]
        lbd = compute_exponential_lambda(q)
        lbds[field] = lbd
        qt = 1.0 - np.exp(-q.astype(np.float64) * lbd)
        sub[sl] = qt.mean(axis=0)
        div[sl] = qt.max(axis=0) - qt.min(axis=0)
    return NormStats(inp_sub=sub, inp_div=div, out_scale=osc, **lbds)


def load_asset_norms(version: str) -> NormStats:
    """Load the packaged normalization vectors for a varspec version."""
    import importlib.resources as res

    with res.as_file(
        res.files("climsim_tpu_torch") / "assets" / f"norms_{version}.npz"
    ) as p:
        return NormStats.from_npz(str(p))


def compute_exponential_lambda(q: np.ndarray, threshold: float = 1e-7,
                               fill: float = 1e7) -> np.ndarray:
    """Per-level cloud exponential-transform rate lambda = 1/mean(q | q >
    threshold); levels with no cloudy samples get a huge rate (transform
    saturates immediately).  Mirrors cloud_exponential_transformation.ipynb
    cells 5-7 (nan -> 1e7 fill).

    q: (N, levels) raw cloud water (qc, qi, or qn).
    """
    q = np.asarray(q, np.float64)
    lbd = np.empty(q.shape[1])
    for l in range(q.shape[1]):
        col = q[:, l]
        cloudy = col[col > threshold]
        lbd[l] = 1.0 / cloudy.mean() if cloudy.size else fill
    return np.where(np.isfinite(lbd), lbd, fill)

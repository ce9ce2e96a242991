"""Weight porting: ``climsim_tpu`` flax parameters -> ``climsim_tpu_torch``.

The inverse of ``climsim_tpu.utils.migrate.port_online_mlp``: a flax Dense
kernel is (in, out), a torch Linear weight (out, in), so kernels are
transposed.  Inputs are plain numpy mappings (extract a flax tree with
``jax.tree.map(np.asarray, params["params"])``); dtypes are preserved.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _linear(prefix: str, dense: dict) -> dict:
    return {prefix + "weight": torch.from_numpy(
                np.ascontiguousarray(np.asarray(dense["kernel"]).T)),
            prefix + "bias": torch.from_numpy(
                np.array(dense["bias"], copy=True))}


def port_flax_online_mlp(params: dict) -> dict:
    """``{"MLPTrunk_0": {"Dense_i": {kernel, bias}}, "out": {...}}`` ->
    a ``models.mlp.OnlineMLP`` state_dict.

    Trunk layers go in order of their declaration index i (``Dense_10``
    after ``Dense_2``, which a sort of the key strings would not give).
    """
    trunk = params["MLPTrunk_0"]
    index = {}
    for name in trunk:
        m = re.fullmatch(r"Dense_(\d+)", name)
        if m is None:
            raise KeyError(f"unexpected trunk entry {name!r}")
        index[int(m.group(1))] = name
    if sorted(index) != list(range(len(index))):
        raise KeyError(f"trunk layers {sorted(index)} are not 0..n-1")
    state = {}
    for i in range(len(index)):
        state.update(_linear(f"trunk.layers.{i}.", trunk[index[i]]))
    state.update(_linear("out.", params["out"]))
    return state

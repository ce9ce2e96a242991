"""Weight porting: ``climsim_tpu`` flax parameters -> ``climsim_tpu_torch``.

The inverse of ``climsim_tpu.utils.migrate.port_online_mlp``: a flax Dense
kernel is (in, out), a torch Linear weight (out, in), so kernels are
transposed; a flax conv kernel is (K, Cin, Cout), a torch one (Cout, Cin,
K).  Inputs are plain numpy mappings (extract a flax tree with
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


def _trunk(trunk: dict) -> dict:
    """An ``MLPTrunk_0`` subtree -> ``trunk.layers.i.*``, in order of the
    declaration index i (``Dense_10`` after ``Dense_2``, which a sort of
    the key strings would not give)."""
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
    return state


def port_flax_online_mlp(params: dict) -> dict:
    """``{"MLPTrunk_0": {"Dense_i": {kernel, bias}}, "out": {...}}`` ->
    a ``models.mlp.OnlineMLP`` state_dict."""
    state = _trunk(params["MLPTrunk_0"])
    state.update(_linear("out.", params["out"]))
    return state


def port_flax_mlp(params: dict) -> dict:
    """A ``climsim_tpu.models.mlp.ClimSimMLP`` tree (``MLPTrunk_0``,
    ``prehead``, ``LinReluHead_0`` with ``out_linear`` and ``out_relu``;
    a ``{"params": ...}`` wrapper is unwrapped) -> a
    ``models.mlp.ClimSimMLP`` state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    if set(params) != {"MLPTrunk_0", "prehead", "LinReluHead_0"}:
        raise KeyError(f"not a ClimSimMLP tree: {sorted(params)}")
    head = params["LinReluHead_0"]
    state = _trunk(params["MLPTrunk_0"])
    state.update(_linear("prehead.", params["prehead"]))
    state.update(_linear("head.out_linear.", head["out_linear"]))
    state.update(_linear("head.out_relu.", head["out_relu"]))
    return state


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


def _unet_leaves(tree: dict, prefix: str, state: dict) -> None:
    """Map one flax subtree onto ``state``: a Conv1d / IdentityConv (its
    nn.Conv nested as ``Conv_0``), a GroupNorm (``scale``, ``bias``), the
    ``emb_loc`` table, or a module holding more of them."""
    for name, sub in tree.items():
        key = prefix + name
        if not isinstance(sub, dict):
            if key != "emb_loc":
                raise KeyError(f"unexpected leaf {key!r}")
            state[key] = _tensor(sub)
        elif set(sub) == {"Conv_0"}:
            conv = sub["Conv_0"]
            if set(conv) != {"kernel", "bias"} or np.ndim(conv["kernel"]) != 3:
                raise KeyError(f"{key}.Conv_0: want a (K, Cin, Cout) kernel "
                               f"and a bias, got {sorted(conv)}")
            state[key + ".weight"] = _tensor(
                np.transpose(np.asarray(conv["kernel"]), (2, 1, 0)))
            state[key + ".bias"] = _tensor(conv["bias"])
        elif set(sub) == {"scale", "bias"}:
            state[key + ".weight"] = _tensor(sub["scale"])
            state[key + ".bias"] = _tensor(sub["bias"])
        else:
            _unet_leaves(sub, key + ".", state)


def port_flax_unet(params: dict, model: torch.nn.Module) -> dict:
    """A ``climsim_tpu.models.unet.ClimSimUNet`` parameter tree (numpy
    leaves; a ``{"params": ...}`` wrapper is unwrapped) -> a
    ``models.unet.ClimSimUNet`` state_dict.

    Module names carry over as they are; conv kernels are transposed to
    torch's (Cout, Cin, K), GroupNorm ``scale`` becomes ``weight``.  Raises
    unless every flax leaf lands in exactly one tensor and the result
    fills every tensor of ``model``'s state_dict, each at its shape.
    """
    if set(params) == {"params"}:
        params = params["params"]
    state: dict = {}
    _unet_leaves(params, "", state)
    if len(state) != _n_leaves(params):
        raise KeyError(f"{_n_leaves(params)} flax leaves mapped onto "
                       f"{len(state)} tensors")
    want = model.state_dict()
    missing, extra = sorted(set(want) - set(state)), sorted(
        set(state) - set(want))
    if missing or extra:
        raise KeyError(f"tree and model differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for k, v in want.items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: flax {tuple(state[k].shape)}, model "
                             f"{tuple(v.shape)}")
    return state

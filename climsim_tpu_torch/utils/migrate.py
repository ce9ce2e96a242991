"""Weight porting onto the port's torch models.

``port_flax_*``: ``climsim_tpu`` flax parameters -> ``climsim_tpu_torch``
state_dicts.  A flax Dense kernel is (in, out), a torch Linear weight
(out, in), so kernels are transposed; a flax conv kernel is (K, Cin,
Cout), a torch one (Cout, Cin, K); a LayerNorm's ``scale`` becomes
``weight``.  Trunk layers go in order of their declaration index.  The
RPN ensemble keeps the flax layout, stacked: (E, in, out) a layer.

``port_online_mlp``, ``port_hsr``, ``port_cvae``, ``port_climsim_unet``
and ``port_keras_{mlp,ed,cnn}``: the reference's checkpoints (torch
state_dicts of the online models and the HSR / cVAE baselines, Keras
weight lists of MLP / ED / CNN) -> the port's state_dicts, by the JAX
package's converters to the flax layout (``flax_migrate``, its copy byte
for byte) followed by the porter above.

Inputs are plain numpy mappings (extract a flax tree with
``jax.tree.map(np.asarray, params["params"])``); dtypes are preserved.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from . import flax_migrate as _ref


def _linear(prefix: str, dense: dict) -> dict:
    return {prefix + "weight": torch.from_numpy(
                np.ascontiguousarray(np.asarray(dense["kernel"]).T)),
            prefix + "bias": torch.from_numpy(
                np.array(dense["bias"], copy=True))}


def _norm(prefix: str, norm: dict) -> dict:
    return {prefix + "weight": _tensor(norm["scale"]),
            prefix + "bias": _tensor(norm["bias"])}


def _trunk(trunk: dict, prefix: str = "trunk.") -> dict:
    """An ``MLPTrunk`` subtree -> ``{prefix}layers.i.*`` (``Dense_i``) and
    ``{prefix}norms.i.*`` (``LayerNorm_i``), in order of the declaration
    index i (``Dense_10`` after ``Dense_2``, which a sort of the key
    strings would not give)."""
    index: dict = {"Dense": {}, "LayerNorm": {}}
    for name in trunk:
        m = re.fullmatch(r"(Dense|LayerNorm)_(\d+)", name)
        if m is None:
            raise KeyError(f"unexpected trunk entry {name!r}")
        index[m.group(1)][int(m.group(2))] = name
    n = len(index["Dense"])
    if sorted(index["Dense"]) != list(range(n)) or (
            index["LayerNorm"] and sorted(index["LayerNorm"])
            != list(range(n))):
        raise KeyError(f"trunk layers {sorted(trunk)} are not 0..n-1")
    state = {}
    for i in range(n):
        state.update(_linear(f"{prefix}layers.{i}.",
                             trunk[index["Dense"][i]]))
        if index["LayerNorm"]:
            state.update(_norm(f"{prefix}norms.{i}.",
                               trunk[index["LayerNorm"][i]]))
    return state


def _unwrap(params: dict, keys: set, what: str) -> dict:
    """``params`` without a ``{"params": ...}`` wrapper, its top-level keys
    checked against ``keys``."""
    if set(params) == {"params"}:
        params = params["params"]
    if set(params) != keys:
        raise KeyError(f"not a {what} tree: {sorted(params)}")
    return params


def port_flax_online_mlp(params: dict) -> dict:
    """``{"MLPTrunk_0": {"Dense_i": {kernel, bias}}, "out": {...}}`` ->
    a ``models.mlp.OnlineMLP`` state_dict (or a ``models.rpn.RPNNet``'s,
    one member of the same layout)."""
    params = _unwrap(params, {"MLPTrunk_0", "out"}, "OnlineMLP")
    state = _trunk(params["MLPTrunk_0"])
    state.update(_linear("out.", params["out"]))
    return state


def port_flax_mlp(params: dict) -> dict:
    """A ``climsim_tpu.models.mlp.ClimSimMLP`` tree (``MLPTrunk_0``,
    ``prehead``, ``LinReluHead_0`` with ``out_linear`` and ``out_relu``;
    a ``{"params": ...}`` wrapper is unwrapped) -> a
    ``models.mlp.ClimSimMLP`` state_dict."""
    params = _unwrap(params, {"MLPTrunk_0", "prehead", "LinReluHead_0"},
                     "ClimSimMLP")
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


def port_flax_ed(params: dict) -> dict:
    """A ``climsim_tpu.models.ed.EncoderDecoder`` tree -> a
    ``models.ed.EncoderDecoder`` state_dict."""
    params = _unwrap(params, {"encoder", "decoder", "out"}, "EncoderDecoder")
    state = _trunk(params["encoder"], "encoder.")
    state.update(_trunk(params["decoder"], "decoder."))
    state.update(_linear("out.", params["out"]))
    return state


def port_flax_hsr(params: dict) -> dict:
    """A ``climsim_tpu.models.hsr.HSR`` tree -> a ``models.hsr.HSR``
    state_dict."""
    params = _unwrap(params, {"mean_trunk", "mean_out", "logprec_trunk",
                              "logprec_out"}, "HSR")
    state = {}
    for part in ("mean", "logprec"):
        state.update(_trunk(params[f"{part}_trunk"], f"{part}_trunk."))
        state.update(_linear(f"{part}_out.", params[f"{part}_out"]))
    return state


def port_flax_cvae(params: dict) -> dict:
    """A ``climsim_tpu.models.cvae.CVAE`` tree -> a ``models.cvae.CVAE``
    state_dict."""
    params = _unwrap(params, {"enc_trunk", "enc_mean", "enc_logstd",
                              "dec_trunk", "dec_mean", "dec_logstd"}, "CVAE")
    state = {}
    for name, sub in params.items():
        state.update(_trunk(sub, name + ".") if name.endswith("_trunk")
                     else _linear(name + ".", sub))
    return state


def _conv(prefix: str, conv1d: dict) -> dict:
    """A ``Conv1d`` subtree (its ``nn.Conv`` nested as ``Conv_0``)."""
    conv = conv1d["Conv_0"]
    return {prefix + "weight": _tensor(
                np.transpose(np.asarray(conv["kernel"]), (2, 1, 0))),
            prefix + "bias": _tensor(conv["bias"])}


def port_flax_cnn(params: dict) -> dict:
    """A ``climsim_tpu.models.cnn.ClimSimCNN`` tree (``ResBlock_i`` with
    ``Conv1d_0..2``, then the head's ``Conv1d_0..2``) -> a
    ``models.cnn.ClimSimCNN`` state_dict (``blocks.i.conv0 / conv1 /
    res``, ``head``, ``lin``, ``pos``)."""
    if set(params) == {"params"}:
        params = params["params"]
    depth = sum(1 for k in params if k.startswith("ResBlock_"))
    _unwrap(params, {f"ResBlock_{i}" for i in range(depth)}
            | {"Conv1d_0", "Conv1d_1", "Conv1d_2"}, "ClimSimCNN")
    state = {}
    for i in range(depth):
        blk = params[f"ResBlock_{i}"]
        for j, name in enumerate(("conv0", "conv1", "res")):
            state.update(_conv(f"blocks.{i}.{name}.", blk[f"Conv1d_{j}"]))
    for j, name in enumerate(("head", "lin", "pos")):
        state.update(_conv(f"{name}.", params[f"Conv1d_{j}"]))
    return state


def port_flax_rpn(params: dict, prior: dict) -> dict:
    """The JAX ``RPNEnsemble.init`` pair (trees of ``RPNNet`` stacked over
    a leading member axis) -> a ``models.rpn.RPNEnsemble`` state_dict:
    ``net`` from ``params``, ``prior`` from ``prior``, in the flax kernel
    layout, (E, in, out) a layer."""
    state = {}
    for name, tree in (("net", params), ("prior", prior)):
        tree = _unwrap(tree, {"MLPTrunk_0", "out"}, "RPNNet")
        trunk = tree["MLPTrunk_0"]
        n = len(trunk)
        dense = [trunk[f"Dense_{i}"] for i in range(n)] + [tree["out"]]
        for i, d in enumerate(dense):
            state[f"{name}.weights.{i}"] = _tensor(d["kernel"])
            state[f"{name}.biases.{i}"] = _tensor(d["bias"])
    return state


# -- the reference's checkpoints ---------------------------------------------

def port_online_mlp(state: dict, layers: int) -> dict:
    """MLP_v2rh/training/mlp.py state_dict -> models.mlp.OnlineMLP."""
    return port_flax_online_mlp(_ref.port_online_mlp(state, layers))


def port_hsr(state: dict, layers: int) -> dict:
    """HSR/training/hsr.py state_dict -> models.hsr.HSR."""
    return port_flax_hsr(_ref.port_hsr(state, layers))


def port_cvae(state: dict, layers: int) -> dict:
    """cVAE/training/cvae.py state_dict -> models.cvae.CVAE."""
    return port_flax_cvae(_ref.port_cvae(state, layers))


def port_climsim_unet(state: dict, model: torch.nn.Module, **kw) -> dict:
    """Unet_v{4,5}/training/climsim_unet.py state_dict ->
    models.unet.ClimSimUNet (``model``, built with the reference-parity
    flags, ``skip_conv`` as in ``kw``).  ``kw``: ``channel_mult``,
    ``num_blocks``, ``seq_resolution`` and ``skip_conv``, as
    ``flax_migrate.port_climsim_unet`` takes them."""
    return port_flax_unet(_ref.port_climsim_unet(state, **kw), model)


def port_keras_mlp(dense_weights: list) -> dict:
    """hpo_baseline_v1.py trial model -> models.mlp.ClimSimMLP."""
    return port_flax_mlp(_ref.port_keras_mlp(dense_weights))


def port_keras_ed(enc_weights: list, dec_weights: list) -> dict:
    """ClimSIM_ED_1_3_train.py ED -> models.ed.EncoderDecoder."""
    return port_flax_ed(_ref.port_keras_ed(enc_weights, dec_weights))


def port_keras_cnn(conv_weights: list, depth: int = 12) -> dict:
    """hpo_train.py CNN -> models.cnn.ClimSimCNN."""
    return port_flax_cnn(_ref.port_keras_cnn(conv_weights, depth))

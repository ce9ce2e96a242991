"""Checkpoint migration: reference (torch / Keras) weights -> climsim_tpu.

Users moving from the reference repo (leap-stc/ClimSim) carry trained
checkpoints in three formats: torch ``state_dict``s for the online models
(MLP_v2rh/training/mlp.py, Unet_v5/training/climsim_unet.py) and the
HSR/cVAE baselines, and Keras ``.h5`` weights for MLP/ED/CNN.  The
functions here convert those into flax param pytrees for the corresponding
``climsim_tpu.models`` classes, handling the layout differences:

* torch Linear weight (out, in)      -> flax Dense kernel (in, out)
* torch Conv1d weight (out, in, k)   -> flax Conv kernel (k, in, out)
* torch Group/LayerNorm weight/bias  -> flax scale/bias
* the reference U-Net's interleaved qkv channel layout (q_c at output
  channel 3c, k_c at 3c+1, v_c at 3c+2 -- a consequence of the
  ``reshape(B*H, C/H, 3, L)`` in layers.py:489/786) -> this repo's chunked
  [q | k | v] layout

All inputs are plain numpy mappings/lists (no torch/tf import needed
here); extract with ``{k: v.detach().cpu().numpy() for k, v in
model.state_dict().items()}`` or ``[w for l in keras_model.layers for w in
l.get_weights()]`` style helpers on the source side.

These ports are verified forward-exact (f64, atol 1e-10) against the
reference's own model code in tests/test_model_parity.py; PARITY.md
documents the deliberate architecture deltas and which flags restore
reference-exact behavior (ClimSimUNet: norm1_act=False, resample_proj=True,
attn_heads=1; ClimSimCNN: scalar_head="relu").
"""

from __future__ import annotations

import numpy as np


# dtypes are preserved (a production port casts to float32 afterwards; the
# parity tests run the ported trees at float64 -- an eager downcast here
# would silently truncate Keras's native-f64 weights)

def _dense(w, b):
    return {"kernel": np.asarray(w).T.copy(), "bias": np.asarray(b).copy()}


def _dense_keras(w, b):
    # Keras kernels are already (in, out) -- no transpose, unlike torch
    return {"kernel": np.asarray(w).copy(), "bias": np.asarray(b).copy()}


def _conv(w, b):
    return {"Conv_0": {"kernel": np.asarray(w).transpose(2, 1, 0).copy(),
                       "bias": np.asarray(b).copy()}}


def _norm(w, b):
    return {"scale": np.asarray(w).copy(), "bias": np.asarray(b).copy()}


def _trunk(state: dict, prefix: str, layers: int, layernorm: bool) -> dict:
    """Reference MLP stack (Sequential(Linear[, LayerNorm], Dropout) per
    layer; hsr.py:20-28, mlp.py:40-48) -> MLPTrunk params."""
    out = {}
    for i in range(layers):
        # the HSR/cVAE blocks register as `linear{i}`, the MLP_v2rh
        # ModuleList as `linears.{i}`; inside, index 0 is the Linear and,
        # when present, index 1 the LayerNorm
        for key in (f"{prefix}linear{i}.", f"{prefix}linears.{i}."):
            if key + "0.weight" in state:
                break
        else:
            raise KeyError(f"no linear layer {i} under {prefix!r}")
        out[f"Dense_{i}"] = _dense(state[key + "0.weight"],
                                   state[key + "0.bias"])
        if layernorm:
            out[f"LayerNorm_{i}"] = _norm(state[key + "1.weight"],
                                          state[key + "1.bias"])
    return out


# --------------------------------------------------------------------------
# torch models
# --------------------------------------------------------------------------

def port_online_mlp(state: dict, layers: int) -> dict:
    """MLP_v2rh/training/mlp.py state_dict -> models.mlp.OnlineMLP params."""
    return {"MLPTrunk_0": _trunk(state, "", layers, layernorm=False),
            "out": _dense(state["final_linear.weight"],
                          state["final_linear.bias"])}


def port_hsr(state: dict, layers: int) -> dict:
    """HSR/training/hsr.py state_dict -> models.hsr.HSR params."""
    return {
        "mean_trunk": _trunk(state, "mean.", layers, layernorm=True),
        "mean_out": _dense(state["mean.final_linear.weight"],
                           state["mean.final_linear.bias"]),
        "logprec_trunk": _trunk(state, "logprec.", layers, layernorm=True),
        "logprec_out": _dense(state["logprec.final_linear.weight"],
                              state["logprec.final_linear.bias"]),
    }


def port_cvae(state: dict, layers: int) -> dict:
    """cVAE/training/cvae.py state_dict -> models.cvae.CVAE params."""
    return {
        "enc_trunk": _trunk(state, "encoder.", layers, layernorm=True),
        "enc_mean": _dense(state["encoder.linear_mean.weight"],
                           state["encoder.linear_mean.bias"]),
        "enc_logstd": _dense(state["encoder.linear_logstd.weight"],
                             state["encoder.linear_logstd.bias"]),
        "dec_trunk": _trunk(state, "decoder.", layers, layernorm=True),
        "dec_mean": _dense(state["decoder.final_linear1.weight"],
                           state["decoder.final_linear1.bias"]),
        "dec_logstd": _dense(state["decoder.final_log_std1.weight"],
                             state["decoder.final_log_std1.bias"]),
    }


def _permute_qkv(w: np.ndarray, b: np.ndarray):
    """Reference interleaved qkv conv (out channel 3c+j holds {q,k,v}[j]
    channel c) -> chunked [q | k | v] output channels."""
    c3 = w.shape[0]
    assert c3 % 3 == 0
    c = c3 // 3
    perm = np.empty(c3, np.int64)
    for j in range(3):
        perm[j * c:(j + 1) * c] = np.arange(c) * 3 + j
    return w[perm], b[perm]


def _port_unet_block(state: dict, prefix: str) -> dict:
    """One UNetBlock{,_noatten,_atten} (layers.py:502-797) -> params for
    models.unet.UNetBlock (ref-parity flags)."""
    out = {
        "norm0": _norm(state[prefix + "norm0.weight"],
                       state[prefix + "norm0.bias"]),
        "conv0": _conv(state[prefix + "conv0.weight"],
                       state[prefix + "conv0.bias"]),
        "norm1": _norm(state[prefix + "norm1.weight"],
                       state[prefix + "norm1.bias"]),
        "conv1": _conv(state[prefix + "conv1.weight"],
                       state[prefix + "conv1.bias"]),
    }
    if prefix + "skip.weight" in state:
        out["skip"] = _conv(state[prefix + "skip.weight"],
                            state[prefix + "skip.bias"])
    if prefix + "qkv.weight" in state:
        qw, qb = _permute_qkv(state[prefix + "qkv.weight"],
                              state[prefix + "qkv.bias"])
        out["Attention_0"] = {
            "norm": _norm(state[prefix + "norm2.weight"],
                          state[prefix + "norm2.bias"]),
            "qkv": _conv(qw, qb),
            "proj": _conv(state[prefix + "proj.weight"],
                          state[prefix + "proj.bias"]),
        }
    return out


def port_climsim_unet(state: dict, channel_mult=(1, 2, 2, 2),
                      num_blocks: int = 4, seq_resolution: int = 64,
                      skip_conv: bool = False) -> dict:
    """Unet_v{4,5}/training/climsim_unet.py state_dict ->
    models.unet.ClimSimUNet params.

    The target ClimSimUNet must be built with the reference-parity flags
    (norm1_act=False, resample_proj=True, attn_heads=1) and ``skip_conv``
    matching this call.  With ``skip_conv=False`` (the reference default,
    climsim_unet.py:211-218: frozen at identity) every skip conv is
    verified to be identity and dropped -- an exact no-op; a non-identity
    weight raises, because a skip_conv=False target has nowhere to hold
    it.  With ``skip_conv=True`` every skip conv is ported, identity or
    not -- the target expects a ``skipconv{i}`` for each skip.
    """
    params: dict = {"emb_loc": np.asarray(state["emb_loc"]).copy()}
    for level in range(len(channel_mult)):
        res = seq_resolution >> level
        if level == 0:
            params[f"enc{res}_conv"] = _conv(
                state[f"enc.{res}_conv.weight"],
                state[f"enc.{res}_conv.bias"])
        else:
            params[f"enc{res}_down"] = _port_unet_block(
                state, f"enc.{res}_down.")
        for i in range(num_blocks):
            params[f"enc{res}_block{i}"] = _port_unet_block(
                state, f"enc.{res}_block{i}.")
    for level in reversed(range(len(channel_mult))):
        res = seq_resolution >> level
        if level == len(channel_mult) - 1:
            params[f"dec{res}_in0"] = _port_unet_block(
                state, f"dec.{res}_in0.")
            params[f"dec{res}_in1"] = _port_unet_block(
                state, f"dec.{res}_in1.")
        else:
            params[f"dec{res}_up"] = _port_unet_block(
                state, f"dec.{res}_up.")
        for i in range(num_blocks + 1):
            params[f"dec{res}_block{i}"] = _port_unet_block(
                state, f"dec.{res}_block{i}.")
    res0 = seq_resolution
    params["out_norm"] = _norm(state[f"dec_aux_norm.{res0}_aux_norm.weight"],
                               state[f"dec_aux_norm.{res0}_aux_norm.bias"])
    params["out_conv"] = _conv(state[f"dec_aux_conv.{res0}_aux_conv.weight"],
                               state[f"dec_aux_conv.{res0}_aux_conv.bias"])

    i = 0
    while f"skip_conv_layer.{i}.weight" in state:
        w = np.asarray(state[f"skip_conv_layer.{i}.weight"])  # (C, C, 1)
        b = np.asarray(state[f"skip_conv_layer.{i}.bias"])
        if skip_conv:
            params[f"skipconv{i}"] = {
                "Conv_0": {"kernel": w.transpose(2, 1, 0).copy(),
                           "bias": b.copy()}}
        elif not (np.array_equal(w[:, :, 0],
                                 np.eye(w.shape[0], dtype=w.dtype))
                  and not b.any()):
            raise ValueError(
                f"skip_conv_layer.{i} is not identity but the target is "
                "skip_conv=False; port with skip_conv=True")
        i += 1
    return params


# --------------------------------------------------------------------------
# Keras models (weights as [(kernel, bias), ...] per Dense/Conv layer, in
# model.layers order -- Keras kernels are already (in, out) / (k, in, out))
# --------------------------------------------------------------------------

def port_keras_mlp(dense_weights: list) -> dict:
    """hpo_baseline_v1.py trial model -> models.mlp.ClimSimMLP params.
    dense_weights: trunk layers..., pre-head, linear head, relu head."""
    *trunk, prehead, out_lin, out_relu = dense_weights
    params = {"MLPTrunk_0": {f"Dense_{i}": _dense_keras(w, b)
                             for i, (w, b) in enumerate(trunk)}}
    params["prehead"] = _dense_keras(*prehead)
    params["LinReluHead_0"] = {
        "out_linear": _dense_keras(*out_lin),
        "out_relu": _dense_keras(*out_relu),
    }
    return params


def port_keras_ed(enc_weights: list, dec_weights: list) -> dict:
    """ClimSIM_ED_1_3_train.py ED -> models.ed.EncoderDecoder params."""
    assert len(dec_weights) >= 2
    params = {
        "encoder": {f"Dense_{i}": _dense_keras(w, b)
                    for i, (w, b) in enumerate(enc_weights)},
        "decoder": {f"Dense_{i}": _dense_keras(w, b)
                    for i, (w, b) in enumerate(dec_weights[:-1])},
        "out": _dense_keras(*dec_weights[-1]),
    }
    return params


def _keras_conv(w, b):
    w = np.asarray(w)
    if w.ndim == 2:  # Dense applied per-level == 1x1 conv
        w = w[None]
    return {"Conv_0": {"kernel": w.copy(), "bias": np.asarray(b).copy()}}


def port_keras_cnn(conv_weights: list, depth: int = 12) -> dict:
    """hpo_train.py CNN -> models.cnn.ClimSimCNN params.
    conv_weights: per residual block [conv1, conv2, res_proj] triples in
    layer order, then [head_conv(elu), head_linear, head_relu]."""
    assert len(conv_weights) == 3 * depth + 3
    params = {}
    for blk in range(depth):
        c1, c2, res = conv_weights[3 * blk:3 * blk + 3]
        params[f"ResBlock_{blk}"] = {"Conv1d_0": _keras_conv(*c1),
                                     "Conv1d_1": _keras_conv(*c2),
                                     "Conv1d_2": _keras_conv(*res)}
    head, lin, rel = conv_weights[-3:]
    params["Conv1d_0"] = _keras_conv(*head)
    params["Conv1d_1"] = _keras_conv(*lin)
    params["Conv1d_2"] = _keras_conv(*rel)
    return params

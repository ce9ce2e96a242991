"""The port's models (climsim_tpu_torch.models) against the flax models of
climsim_tpu, with the weights moved across by the porter
(climsim_tpu_torch.utils.migrate).

Tolerances: at compute_dtype=float32 rtol 1e-5, atol 1e-6; at bf16 the
repo's bf16 tolerance atol 2e-2 * max|y| (tests/test_pallas_kernels.py:172):
one flipped bf16 rounding moves a value by 2**-8 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import OnlineMLP as FlaxOnlineMLP
from climsim_tpu.models.common import Dense as FlaxDense
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.models import OnlineMLP, build_model
from climsim_tpu_torch.models.common import Dense, out_dtype
from climsim_tpu_torch.ops import kernels as PK
from climsim_tpu_torch.utils.migrate import port_flax_online_mlp

SPEC = get_varspec("v2_rh")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype):
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params["params"])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_matches_flax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(0).standard_normal((9, 40)).astype(np.float32)
    fl = FlaxDense(24, jdt)
    params = fl.init(jax.random.PRNGKey(1), jnp.asarray(x))
    p = _numpy_tree(params)
    p["bias"] = np.random.default_rng(2).standard_normal(24).astype(
        np.float32)
    want = np.asarray(fl.apply({"params": p}, jnp.asarray(x)), np.float32)

    # through the porter, as the model's head
    state = port_flax_online_mlp({"MLPTrunk_0": {}, "out": p})
    d = Dense(40, 24, tdt)
    d.load_state_dict({k.removeprefix("out."): v for k, v in state.items()})
    with torch.no_grad():
        y = d(torch.from_numpy(x))
    assert y.dtype == tdt
    _close(y.float().numpy(), want, dtype)


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_online_mlp_matches_flax(dtype, prune):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(3).standard_normal(
        (16, SPEC.input_len)).astype(np.float32)
    fl = FlaxOnlineMLP(spec=SPEC, hidden=(64, 48), output_prune=prune,
                       compute_dtype=jdt)
    params = fl.init(jax.random.PRNGKey(4), jnp.asarray(x))
    want = np.asarray(fl.apply(params, jnp.asarray(x)))

    m = OnlineMLP(SPEC, hidden=(64, 48), output_prune=prune,
                  compute_dtype=tdt)
    m.load_state_dict(port_flax_online_mlp(_numpy_tree(params)))
    with torch.no_grad():
        y = m(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (16, SPEC.output_len)
    _close(y.numpy(), want, dtype)
    assert (y[:, -8:] >= 0).all()
    if prune:  # stratosphere of every non-temperature profile is zero
        s = SPEC.output_slices["ptend_q0001"].start
        assert (y[:, s:s + 12] == 0).all()


def test_porter_orders_layers_by_index():
    """Dense_10 comes after Dense_2: the porter and mlp_params_to_matrices
    follow the declaration index, not the sorted key strings."""
    widths = [SPEC.input_len] + [8 + i for i in range(11)]
    rng = np.random.default_rng(5)
    tree = {"MLPTrunk_0": {
        f"Dense_{i}": {"kernel": rng.standard_normal(
            (widths[i], widths[i + 1])).astype(np.float32),
            "bias": np.full(widths[i + 1], i, np.float32)}
        for i in range(11)},
        "out": {"kernel": np.ones((widths[-1], SPEC.output_len), np.float32),
                "bias": np.zeros(SPEC.output_len, np.float32)}}
    state = port_flax_online_mlp(tree)
    m = OnlineMLP(SPEC, hidden=tuple(widths[1:]))
    m.load_state_dict(state)
    ws, bs = PK.mlp_params_to_matrices(m.state_dict())
    assert [tuple(w.shape) for w in ws] == list(
        zip(widths, widths[1:] + [SPEC.output_len]))
    assert [float(b[0]) for b in bs[:11]] == [float(i) for i in range(11)]
    np.testing.assert_array_equal(ws[10].numpy(),
                                  tree["MLPTrunk_0"]["Dense_10"]["kernel"])


def test_build_model_and_init():
    gen = torch.Generator().manual_seed(0)
    m = build_model("mlp_online", SPEC, hidden=(256,), generator=gen)
    assert isinstance(m, OnlineMLP)
    w = m.trunk.layers[0].weight
    # lecun_normal: truncated normal with variance 1/fan_in, within 2 std
    assert abs(w.std().item() * np.sqrt(SPEC.input_len) - 1.0) < 0.05
    assert w.abs().max().item() <= 2 * np.sqrt(1 / SPEC.input_len) / 0.8796
    again = build_model("mlp_online", SPEC, hidden=(256,),
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.trunk.layers[0].weight, w)
    assert out_dtype(torch.bfloat16) == torch.float32
    assert out_dtype(torch.float64) == torch.float64
    # the CNN, once refused, is ported (tests/test_torch_zoo.py holds it
    # to flax); a name the registry lacks still raises
    from climsim_tpu_torch.models import ClimSimCNN

    assert isinstance(build_model("cnn", SPEC, depth=1, channels=8),
                      ClimSimCNN)
    with pytest.raises(KeyError):
        build_model("gan", SPEC)

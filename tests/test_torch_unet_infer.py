"""The port's fused-inference engine (climsim_tpu_torch.ops.unet_infer)
against the JAX engine (climsim_tpu.ops.unet_infer, its Pallas kernel in
interpret mode), fused and all-plain, on the same perturbed weights and
seeded columns; tolerances as tests/test_torch_unet.py says."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models.unet import ClimSimUNet as FlaxUNet
from climsim_tpu.ops.unet_infer import unet_apply_fused as jax_engine
from climsim_tpu_torch.models import ClimSimUNet
from climsim_tpu_torch.ops import kernels as PK
from climsim_tpu_torch.ops.unet_infer import unet_apply_fused
from test_torch_unet import (DTYPES, SPEC, TINY, close, columns, flax_case,
                             port_model)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", ["attn", "classifier", "prune",
                                     "skipconv"])
def test_engine_matches_jax_engine(variant, dtype):
    jdt, tdt = DTYPES[dtype]
    kw, tree = flax_case(variant)
    fm = FlaxUNet(spec=SPEC, compute_dtype=jdt, **kw)
    m = port_model(kw, tree, tdt)
    x = columns(7, seed=2)
    PK.reset_launches()
    for fused in (True, False):
        want = np.asarray(jax_engine(fm, tree, jnp.asarray(x), fused=fused),
                          np.float64)
        with torch.inference_mode():
            got = unet_apply_fused(m, torch.from_numpy(x), fused=fused)
        assert got.shape == want.shape and got.dtype == torch.float32
        close(got.double().numpy(), want, dtype)
    assert PK.LAUNCHES["fused_gn_silu_conv3"] == 0   # CPU: plain version


def test_engine_takes_any_batch():
    """No batch tile: B = 1 and ragged sizes run, and each sample's
    answer is the one it gets alone."""
    kw, tree = flax_case("attn")
    m = port_model(kw, tree, torch.bfloat16)
    x = torch.from_numpy(columns(7, seed=4))
    with torch.inference_mode():
        whole = unet_apply_fused(m, x)
        for i in (0, 6):
            np.testing.assert_allclose(
                unet_apply_fused(m, x[i:i + 1]).numpy(), whole[i:i + 1],
                rtol=1e-5, atol=1e-6 * float(whole.abs().max()))


def test_engine_rereads_changed_weights():
    kw, tree = flax_case("attn")
    m = port_model(kw, tree, torch.float32)
    x = torch.from_numpy(columns(3))
    with torch.inference_mode():
        a = unet_apply_fused(m, x)
    with torch.no_grad():
        m.enc64_block0.conv0.weight.mul_(2.0)
    with torch.inference_mode():
        b = unet_apply_fused(m, x)
        c = m(x)
    assert not torch.allclose(a, b)
    close(b.double().numpy(), c.double().numpy(), "f32")


REFUSED = {"resample_proj": dict(resample_proj=True),
           "norm1_act": dict(norm1_act=False),
           "attn_heads": dict(attn_heads=1),
           "classifier_forcing": dict(classifier=True, output_prune=True)}


@pytest.mark.parametrize("flag", sorted(REFUSED))
def test_engine_refuses_flags_the_jax_engine_ignores(flag):
    m = ClimSimUNet(SPEC, **TINY, **REFUSED[flag])
    with pytest.raises(ValueError, match="default U-Net"):
        unet_apply_fused(m, torch.from_numpy(columns(2)))


def test_jax_engine_gap_on_resample_proj():
    """The fault of the reference the refusal guards against: with
    resample_proj=True the JAX engine drops the resample blocks' 1x1 skip
    convs (climsim_tpu/ops/unet_infer.py:114) and answers another
    network's output, ~10% off model.apply at float32."""
    kw, tree = flax_case("reference_flags")
    fm = FlaxUNet(spec=SPEC, compute_dtype=jnp.float32, **kw)
    x = jnp.asarray(columns())
    ref = np.asarray(fm.apply({"params": tree}, x))
    eng = np.asarray(jax_engine(fm, tree, x, fused=False))
    gap = np.abs(eng - ref).max() / np.abs(ref).max()
    assert gap > 1e-2, gap

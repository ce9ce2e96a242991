"""The port's experiment configuration (climsim_tpu_torch.config) against
climsim_tpu.config: every preset field by field (exact: the tables hold
the same literals), the dotted overrides and the JSON round trip."""

import dataclasses
import json

import pytest

from climsim_tpu import config as JC
from climsim_tpu_torch import config as PC


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_preset_names_match_jax():
    assert list(PC.PRESETS) == list(JC.PRESETS)


@pytest.mark.parametrize("name", sorted(JC.PRESETS))
def test_preset_matches_jax(name):
    want, got = _fields(JC.PRESETS[name]), _fields(PC.PRESETS[name])
    assert set(got) == set(want)
    for section in want:
        assert got[section] == want[section], (name, section)


def test_override_and_json_match_jax():
    sets = ("model_kw.model_channels=32", "train.epochs=3",
            "data.batch_size=64", "transform.strato_lev=12",
            "train.schedule=step", 'model_kw.channel_mult=[1, 2]')
    want = JC.PRESETS["unet_v5"].override(*sets)
    got = PC.PRESETS["unet_v5"].override(*sets)
    assert _fields(got) == _fields(want)
    assert got.to_json() == want.to_json()
    back = PC.ExperimentConfig.from_dict(json.loads(got.to_json()))
    assert back.to_json() == got.to_json()
    assert isinstance(back.transform, PC.TransformConfig)
    # the preset itself is untouched
    assert PC.PRESETS["unet_v5"].model_kw["model_channels"] == 128

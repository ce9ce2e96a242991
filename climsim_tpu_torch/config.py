"""Typed experiment configuration (the counterpart of
``climsim_tpu.config``).

``ExperimentConfig`` is a plain dataclass tree -- serializable to and from
JSON, overridable with dotted key=value strings (CLI).  ``PRESETS`` holds
each reference model's shipped training configuration, the JAX package's
table field for field over the port's own ``TransformConfig``;
``python -m climsim_tpu_torch.run --preset NAME`` trains any of them.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

from .data.transforms import TransformConfig, v5_online_config


@dataclass
class DataConfig:
    varspec: str = "v1"
    source: str = "synthetic"        # 'synthetic' | 'shards'
    input_path: str | None = None    # {split}_input.npy for shards
    target_path: str | None = None
    num_synthetic: int = 16 * 384
    val_fraction: float = 0.1
    batch_size: int = 1024
    norms: str = "asset"             # 'asset' | 'compute' | 'identity'
    use_native_loader: bool = True
    loader: str = "auto"    # auto | host | device
    block_shuffle: int = 0  # >0: device-loader block shuffling (B rows)
    seed: int = 0


@dataclass
class TrainConfig:
    epochs: int = 10
    lr: float = 1e-3
    loss: str = "mse"
    schedule: str = "constant"
    block_weights: dict = field(default_factory=dict)
    energy_weight: float = 0.0
    optimizer: str = "adam"
    checkpoint_dir: str | None = None
    # warm restart: load the weights of a prior run before training (a
    # fresh optimizer state, the reference's cfg.restart_path,
    # train_unet_h5loader.py:177-189)
    restart_path: str | None = None
    top_k: int = 5
    timed_interval: float = 0.0  # >0: periodic wall-clock save (seconds)
    early_stop_patience: int = 0
    plateau_patience: int = 0
    num_data_shards: int = 0          # 0 = all local devices
    seeds: list = field(default_factory=list)   # >1: multi-seed run
    lr_scales: list = field(default_factory=list)  # per-seed LR multipliers
    elastic: bool = False  # in-flight device-loss recovery


@dataclass
class ExperimentConfig:
    model: str = "mlp"
    model_kw: dict = field(default_factory=dict)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    transform: TransformConfig = field(default_factory=TransformConfig)
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        d = dict(d)
        if isinstance(d.get("data"), dict):
            d["data"] = DataConfig(**d["data"])
        if isinstance(d.get("train"), dict):
            d["train"] = TrainConfig(**d["train"])
        if isinstance(d.get("transform"), dict):
            d["transform"] = TransformConfig(**d["transform"])
        return cls(**d)

    def override(self, *assignments: str) -> "ExperimentConfig":
        """Apply 'a.b=c' dotted overrides (CLI); values parse as JSON where
        they can, else stay strings."""
        d = dataclasses.asdict(self)
        for a in assignments:
            key, _, raw = a.partition("=")
            try:
                val = json.loads(raw)
            except json.JSONDecodeError:
                val = raw
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = val
        return ExperimentConfig.from_dict(d)


def _preset(model, varspec, model_kw=None, train_kw=None, data_kw=None,
            transform=None):
    return ExperimentConfig(
        model=model, model_kw=model_kw or {},
        data=DataConfig(varspec=varspec, **(data_kw or {})),
        train=TrainConfig(**(train_kw or {})),
        transform=transform or TransformConfig())


_UNET = dict(model_channels=128, channel_mult=(1, 2, 2, 2), num_blocks=4,
             attn_resolutions=(8,))

PRESETS: dict[str, ExperimentConfig] = {
    # NeurIPS'23 offline baselines
    "mlp_v1": _preset("mlp", "v1",
                      model_kw=dict(hidden=(768, 640, 512, 640, 640)),
                      train_kw=dict(loss="mse", schedule="cyclic",
                                    epochs=18),
                      data_kw=dict(batch_size=3072)),
    "cnn_v1": _preset("cnn", "v1",
                      model_kw=dict(depth=12, channels=406, dropout=0.175),
                      train_kw=dict(loss="mae", schedule="cyclic",
                                    epochs=15),
                      data_kw=dict(batch_size=512)),
    "mlp_v2": _preset("mlp_v2", "v2",
                      model_kw=dict(hidden=(768, 640, 512, 640, 640)),
                      train_kw=dict(loss="mse", schedule="cyclic",
                                    epochs=18),
                      data_kw=dict(batch_size=3072)),
    "ed_v1": _preset("ed", "v1",
                     model_kw=dict(intermediate=463, latent=5),
                     train_kw=dict(loss="mse", schedule="step", lr=1e-4,
                                   epochs=40),
                     data_kw=dict(batch_size=714)),
    "hsr_v1": _preset("hsr", "v1",
                      model_kw=dict(hidden=1024, layers=4),
                      train_kw=dict(lr=1e-4, epochs=20),
                      data_kw=dict(batch_size=1024)),
    "rpn_v1": _preset("rpn", "v1",
                      model_kw=dict(ensemble_size=32,
                                    hidden=(768, 640, 512, 640, 640)),
                      train_kw=dict(lr=5e-4, epochs=5),
                      data_kw=dict(batch_size=3072)),
    "cvae_v1": _preset("cvae", "v1",
                       model_kw=dict(latent=8, hidden=512, layers=2),
                       train_kw=dict(lr=1e-4, epochs=20),
                       data_kw=dict(batch_size=1024)),
    # coupling-grade online models
    "mlp_v2rh": _preset("mlp_online", "v2_rh",
                        model_kw=dict(hidden=(1024,) * 4),
                        train_kw=dict(loss="mse", epochs=30),
                        data_kw=dict(batch_size=2048)),
    "unet_v4": _preset("unet", "v4", model_kw=dict(_UNET),
                       train_kw=dict(loss="huber", schedule="cosine",
                                     epochs=30),
                       data_kw=dict(batch_size=1024)),
    "unet_v5": _preset("unet", "v5",
                       model_kw=dict(_UNET, output_prune=True,
                                     strato_lev_out=15),
                       train_kw=dict(loss="huber", schedule="cosine",
                                     epochs=30),
                       data_kw=dict(batch_size=1024),
                       transform=v5_online_config()),
    "unet_v5_classifier": _preset(
        "unet_classifier", "v5",
        # output_prune: the production classifier forces class 0 (zero
        # condensate tendency) in the top 12 levels
        # (conf/config_single.yaml:68/71, climsim_unet_classifier.py:396-403)
        model_kw=dict(_UNET, output_prune=True, strato_lev_out=12),
        train_kw=dict(epochs=20), data_kw=dict(batch_size=1024),
        transform=v5_online_config()),
}

"""Model registry.  The port holds the v1 MLP baseline, the coupling MLP
(MLP_v2rh) and the coupling U-Net (Unet_v4/v5 and its classifier) so
far."""

from .mlp import ClimSimMLP, OnlineMLP
from .unet import ClimSimUNet

__all__ = ["ClimSimMLP", "ClimSimUNet", "OnlineMLP", "build_model"]


def build_model(name: str, spec, **kw):
    table = {"mlp": ClimSimMLP, "mlp_online": OnlineMLP,
             "unet": ClimSimUNet}
    if name == "unet_classifier":
        kw = dict(kw)
        kw.setdefault("classifier", True)
        return ClimSimUNet(spec=spec, **kw)
    try:
        cls = table[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; have "
                       f"{sorted([*table, 'unet_classifier'])}") from None
    return cls(spec=spec, **kw)

"""Model registry.  The port holds the coupling MLP (MLP_v2rh) and the
coupling U-Net (Unet_v4/v5 and its classifier) so far."""

from .mlp import OnlineMLP
from .unet import ClimSimUNet

__all__ = ["ClimSimUNet", "OnlineMLP", "build_model"]


def build_model(name: str, spec, **kw):
    table = {"mlp_online": OnlineMLP, "unet": ClimSimUNet}
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

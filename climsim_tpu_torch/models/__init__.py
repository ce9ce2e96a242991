"""Model zoo registry (the counterpart of ``climsim_tpu.models``).

Offline NeurIPS'23 baselines: mlp, cnn, ed, hsr, rpn, cvae
(baseline_models/{MLP,CNN,ED,HSR,RPN,cVAE} in the reference).
Coupling-grade online models: mlp_online (MLP_v2rh), unet (Unet_v4/v5),
unet_classifier.
"""

from .cnn import ClimSimCNN
from .cvae import CVAE
from .ed import EncoderDecoder
from .hsr import HSR
from .mlp import ClimSimMLP, OnlineMLP
from .rpn import RPNEnsemble, RPNNet
from .unet import ClimSimUNet

__all__ = ["CVAE", "ClimSimCNN", "ClimSimMLP", "ClimSimUNet",
           "EncoderDecoder", "HSR", "OnlineMLP", "RPNEnsemble", "RPNNet",
           "build_model"]


def build_model(name: str, spec, **kw):
    table = {"mlp": ClimSimMLP, "mlp_online": OnlineMLP, "cnn": ClimSimCNN,
             "ed": EncoderDecoder, "hsr": HSR, "cvae": CVAE, "rpn": RPNNet,
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

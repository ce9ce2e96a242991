"""climsim_tpu_torch -- the ClimSim engine on PyTorch and CUDA (NVIDIA Hopper).

A port of ``climsim_tpu``: it serves the online coupling sidecar for the
MLP_v2rh and U-Net v5 emulators (raw columns in over TCP, (B, 368)
tendencies out) and trains the v1 MLP and the U-Net v5, with the Pallas
kernels of the JAX package rewritten as CUDA kernels.  Module names
mirror ``climsim_tpu`` so each counterpart is found at once; the JAX
package stays the reference the port is tested against.

The port imports nothing of ``climsim_tpu``: the variable registry, the
grid and the normalization assets are its own copies (``varspec.py``,
``grid.py``, ``norms.py`` and ``assets/*.npz``), which the tests hold to
the JAX package's bit for bit.  Its entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.

Quick tour:

    from climsim_tpu_torch import get_varspec, load_asset_norms
    from climsim_tpu_torch.models import build_model
    from climsim_tpu_torch.online.wrapper import make_fast_mlp_wrapper
    from climsim_tpu_torch.online.server import CouplingServer
    from climsim_tpu_torch.train.recipes import unet_trainer

CLI: ``python -m climsim_tpu_torch.serve --demo v2rh``,
``python -m climsim_tpu_torch.bench_unet_train``.
"""

# Lazy top-level conveniences (PEP 562): `import climsim_tpu_torch` pulls in
# neither torch nor the kernels until something is used.
_LAZY = {
    "get_varspec": ("climsim_tpu_torch.varspec", "get_varspec"),
    "VarSpec": ("climsim_tpu_torch.varspec", "VarSpec"),
    "load_default_grid": ("climsim_tpu_torch.grid", "load_default_grid"),
    "Grid": ("climsim_tpu_torch.grid", "Grid"),
    "load_asset_norms": ("climsim_tpu_torch.norms", "load_asset_norms"),
    "NormStats": ("climsim_tpu_torch.norms", "NormStats"),
    "build_model": ("climsim_tpu_torch.models", "build_model"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'climsim_tpu_torch' has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))

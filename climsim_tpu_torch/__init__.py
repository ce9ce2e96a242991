"""climsim_tpu_torch -- the ClimSim engine on PyTorch and CUDA (NVIDIA Hopper).

A port of ``climsim_tpu`` that serves the online coupling sidecar for the
MLP_v2rh emulator: raw v2_rh columns in over TCP, the input transform, the
whole relu MLP in one hand-written CUDA kernel, un-scaled (B, 368)
tendencies out.  Module names mirror ``climsim_tpu`` so each counterpart is
found at once; the JAX package stays the reference the port is tested
against.

The variable registry, grid and normalization assets are not copied: they
come from the JAX-free modules ``climsim_tpu.varspec``, ``climsim_tpu.grid``
and ``climsim_tpu.norms`` (numpy and the standard library only).

Quick tour:

    from climsim_tpu_torch import get_varspec, load_asset_norms
    from climsim_tpu_torch.models import build_model
    from climsim_tpu_torch.online.wrapper import make_fast_mlp_wrapper
    from climsim_tpu_torch.online.server import CouplingServer

CLI: ``python -m climsim_tpu_torch.serve --demo v2rh``.
"""

# Lazy top-level conveniences (PEP 562): `import climsim_tpu_torch` pulls in
# neither torch nor the kernels until something is used.
_LAZY = {
    "get_varspec": ("climsim_tpu.varspec", "get_varspec"),
    "VarSpec": ("climsim_tpu.varspec", "VarSpec"),
    "load_default_grid": ("climsim_tpu.grid", "load_default_grid"),
    "Grid": ("climsim_tpu.grid", "Grid"),
    "load_asset_norms": ("climsim_tpu.norms", "load_asset_norms"),
    "NormStats": ("climsim_tpu.norms", "NormStats"),
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

"""Model registry.  The port holds the coupling MLP (MLP_v2rh) so far."""

from .mlp import OnlineMLP

__all__ = ["OnlineMLP", "build_model"]


def build_model(name: str, spec, **kw):
    table = {"mlp_online": OnlineMLP}
    try:
        cls = table[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; have {sorted(table)}") from None
    return cls(spec=spec, **kw)

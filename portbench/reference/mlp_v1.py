"""The plain reference of the ``mlp_v1`` configuration: the NeurIPS'23
ClimSim MLP baseline (baseline_models/MLP, HPO baseline_v1): a dense trunk
with ReLU, a dense pre-head with ReLU at the output width, and the
linear / ReLU head (the profile tendencies linear, the surface scalars
through a ReLU), in plain float32 PyTorch.

Parameters carry the names and layouts of the program's state dict
(weights (out, in)).  ``cast`` marks where the program rounds to its
compute dtype: each layer's operands and its result.
"""

from __future__ import annotations

import torch
from torch import nn

from ..traffic.varspec import Layout
from . import common


class Dense(nn.Module):
    def __init__(self, i: int, o: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i))
        self.bias = nn.Parameter(torch.empty(o))

    def forward(self, x, cast):
        return cast(cast(x) @ cast(self.weight).t() + self.bias)


class Trunk(nn.Module):
    def __init__(self, widths):
        super().__init__()
        self.layers = nn.ModuleList(Dense(i, o) for i, o
                                    in zip(widths[:-1], widths[1:]))

    def forward(self, x, cast):
        for layer in self.layers:
            x = torch.relu(layer(x, cast))
        return x


class Head(nn.Module):
    def __init__(self, i: int, lin: int, rel: int):
        super().__init__()
        self.out_linear, self.out_relu = Dense(i, lin), Dense(i, rel)

    def forward(self, x, cast):
        return torch.cat([self.out_linear(x, cast),
                          torch.relu(self.out_relu(x, cast))], -1)


class Model(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        lay = Layout(cfg["varspec"])
        hidden = cfg["model"]["hidden"]
        lin = 60 * len(lay.profiles(lay.outputs))
        rel = len(lay.scalars(lay.outputs))
        self.trunk = Trunk([lay.input_len, *hidden])
        self.prehead = Dense(hidden[-1], lin + rel)
        self.head = Head(lin + rel, lin, rel)

    def forward(self, x, cast=common.exact):
        return self.head(torch.relu(self.prehead(self.trunk(x, cast), cast)),
                         cast)


def make_weights(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        m = Model(cfg)
    shapes = {n: tuple(p.shape) for n, p in m.named_parameters()}
    kinds = {n: "weight" if n.endswith("weight") else "bias" for n in shapes}
    return common.draw_weights(shapes, kinds, seed, device)


def build(cfg: dict, weights: dict) -> Model:
    dev = next(iter(weights.values())).device
    with torch.device(dev):
        m = Model(cfg)
    m.load_state_dict(weights, strict=True)
    return m


def train(cfg: dict, weights: dict, norms: dict, batches, cast=common.exact
          ) -> dict:
    """``common.follow_steps`` over the raw (xb, yb) ``batches``."""
    dev = batches[0][0].device
    model = build(cfg, weights)
    lay = Layout(cfg["varspec"])
    tr = cfg["train"]
    in_t = common.input_transform(lay, norms, tr["transform"], dev)
    tgt_t = common.target_transform(lay, norms, tr["transform"], dev)
    with common.no_tf32():
        return common.follow_steps(lambda x: model(x, cast),
                                   dict(model.named_parameters()), batches,
                                   tr, in_t, tgt_t)

"""The plain reference of the ``unet_v5`` configuration: the ClimSim U-Net
v5 over the vertical column (Unet_v5/training/climsim_unet.py, in the form
the configuration file states), in plain float32 PyTorch, and the v5
coupling wrapper around it (v5_nn_wrapper.ipynb: raw v4 columns in, the
368-wide raw tendencies out).

Parameters carry the names and layouts of the program's state dict, so
one set of weights drawn from the seed loads into both: a convolution's
weight is (Cout, Cin, K), activations are channels-last (B, L, C).
``cast`` marks where the program rounds to its compute dtype: the
operands and the result of each convolution, and the attention's q, k, v
and weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..traffic.varspec import NUM_LEVELS, Layout
from . import common

N_LOC, LOC_DIM = 385, 8


def groups(c: int, cap: int = 32) -> int:
    """min(cap, c // 4) groups, stepped down to a divisor of c."""
    g = min(cap, max(c // 4, 1))
    while c % g:
        g -= 1
    return g


class ConvK(torch.autograd.Function):
    """``F.conv1d`` with SAME padding, K odd: x (B, C, L), w (Cout, C, K).
    The forward and the input's gradient are cuDNN's; the weight's
    gradient is one float32 product of the cotangent with the K shifted
    copies of the input: the same sums in another order, where cuDNN's
    float32 weight gradient (an FFT) takes ~9 times as long at the
    training cell's sizes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv1d(x, w, padding=w.shape[-1] // 2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k, l = w.shape[-1], x.shape[-1]
        dx = (torch.nn.grad.conv1d_input(x.shape, w, g, padding=k // 2)
              if ctx.needs_input_grad[0] else None)
        xp = F.pad(x, (k // 2, k // 2))
        cols = torch.stack([xp[:, :, j:j + l] for j in range(k)], dim=-1)
        return dx, torch.einsum("bol,bclk->ock", g, cols)


class Conv(nn.Module):
    """A convolution over the levels with SAME padding, K odd."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x, cast):
        w = cast(self.weight)
        k = w.shape[-1]
        if k == 1:
            y = cast(x) @ w[:, :, 0].t()
        else:
            y = ConvK.apply(cast(x).transpose(1, 2), w).transpose(1, 2)
        return cast(cast(y) + cast(self.bias))


class Norm(nn.Module):
    """GroupNorm over (L, C / G), eps 1e-6, in float32."""

    def __init__(self, c: int):
        super().__init__()
        self.g = groups(c)
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        b, l, c = x.shape
        xg = x.reshape(b, l, self.g, c // self.g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + 1e-6)).reshape(b, l, c)
        return y * self.weight + self.bias


class Attention(nn.Module):
    """Self-attention over the levels, ``head_dim`` channels a head."""

    def __init__(self, c: int, head_dim: int):
        super().__init__()
        self.heads = max(c // head_dim, 1)
        self.norm = Norm(c)
        self.qkv = Conv(c, 3 * c, 1)
        self.proj = Conv(c, c, 1)

    def forward(self, x, cast):
        b, l, c = x.shape
        d = c // self.heads
        qkv = self.qkv(self.norm(x), cast).reshape(b, l, 3, self.heads, d)
        q, k, v = (cast(qkv[:, :, i]) for i in range(3))
        w = torch.softmax(torch.einsum("blhd,bmhd->bhlm", q, k)
                          / math.sqrt(d), dim=-1)
        out = torch.einsum("bhlm,bmhd->blhd", cast(w), v)
        return (x + self.proj(out.reshape(b, l, c), cast)) / math.sqrt(2.0)


class Block(nn.Module):
    """GroupNorm -> silu -> (resample) -> conv3 -> GroupNorm -> silu ->
    conv3, a 1x1 skip where the width changes, (h + x) / sqrt 2, then
    attention where the level count is an attention resolution."""

    def __init__(self, cin, cout, up=False, down=False, attention=False,
                 head_dim=64):
        super().__init__()
        self.up, self.down = up, down
        self.norm0, self.conv0 = Norm(cin), Conv(cin, cout, 3)
        self.norm1, self.conv1 = Norm(cout), Conv(cout, cout, 3)
        self.skip = Conv(cin, cout, 1) if cin != cout else None
        self.Attention_0 = Attention(cout, head_dim) if attention else None

    def forward(self, x, cast):
        h = F.silu(self.norm0(x))
        if self.down:
            h, x = 0.5 * (h[:, 0::2] + h[:, 1::2]), 0.5 * (x[:, 0::2]
                                                           + x[:, 1::2])
        elif self.up:
            h, x = (torch.repeat_interleave(a, 2, dim=1) for a in (h, x))
        h = self.conv0(h, cast)
        h = self.conv1(F.silu(self.norm1(h)), cast)
        if self.skip is not None:
            x = self.skip(x, cast)
        y = (h + x) / math.sqrt(2.0)
        if self.Attention_0 is not None:
            y = self.Attention_0(y, cast)
        return y


class Model(nn.Module):
    """(B, 1405) normalized v5 columns -> (B, 308) normalized tendencies."""

    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        self.layout = Layout(cfg["varspec"])
        lay = self.layout
        self.n_prof = len(lay.profiles(lay.inputs))
        n_scal = len(lay.scalars(lay.inputs)) - 1          # icol apart
        self.seq = m["seq_resolution"]
        self.mult = m["channel_mult"]
        self.nblocks = m["num_blocks"]
        unsupported = {k: v for k, v in (
            ("norm1_act", True), ("resample_proj", False), ("attn_heads", 0),
            ("dropout", 0.0), ("output_prune", True)) if m[k] != v}
        if unsupported:
            raise ValueError(f"the reference is the network with silu after "
                             f"norm1, no resample projection, 64 channels "
                             f"a head, no dropout and the output pruned; "
                             f"got {unsupported}")
        attn, mc, hd = m["attn_resolutions"], m["model_channels"], 64
        self.strato = m["strato_lev_out"]
        self.emb_loc = nn.Parameter(torch.empty(N_LOC, LOC_DIM))
        keep = torch.ones(n_scal)
        keep[-7:-2] = 0.0          # tm_state_ps .. tm_pbuf_COSZRS
        self.register_buffer("scal_mask", keep, persistent=False)
        c = self.n_prof + n_scal + LOC_DIM
        skips = []
        for level, mult in enumerate(self.mult):
            res = self.seq >> level
            if level == 0:
                self.add_module(f"enc{res}_conv", Conv(c, mc, 3))
                c = mc
            else:
                self.add_module(f"enc{res}_down", Block(c, c, down=True))
            skips.append(c)
            for i in range(self.nblocks):
                self.add_module(f"enc{res}_block{i}", Block(
                    c, mc * mult, attention=res in attn, head_dim=hd))
                c = mc * mult
                skips.append(c)
        for level, mult in reversed(list(enumerate(self.mult))):
            res = self.seq >> level
            if level == len(self.mult) - 1:
                self.add_module(f"dec{res}_in0", Block(c, c, attention=True,
                                                       head_dim=hd))
                self.add_module(f"dec{res}_in1", Block(c, c))
            else:
                self.add_module(f"dec{res}_up", Block(c, c, up=True))
            for i in range(self.nblocks + 1):
                self.add_module(f"dec{res}_block{i}", Block(
                    c + skips.pop(), mc * mult,
                    attention=i == self.nblocks and res in attn,
                    head_dim=hd))
                c = mc * mult
        self.n_prof_out = len(lay.profiles(lay.outputs))
        self.out_norm = Norm(c)
        self.out_conv = Conv(c, self.n_prof_out
                             + len(lay.scalars(lay.outputs)), 3)
        mask = torch.ones(lay.output_len)
        for v in lay.profiles(lay.outputs):
            if v != "ptend_t":
                s = lay.output_slices[v].start
                mask[s:s + self.strato] = 0.0
        self.register_buffer("prune_mask", mask, persistent=False)

    def forward(self, x, cast=common.exact):
        b = x.shape[0]
        prof = x[:, :self.n_prof * NUM_LEVELS].reshape(
            b, self.n_prof, NUM_LEVELS).transpose(1, 2)
        scal = x[:, self.n_prof * NUM_LEVELS:]
        icol, scal = scal[:, -1], scal[:, :-1] * self.scal_mask
        loc = self.emb_loc[torch.clamp(icol.to(torch.int32), 0,
                                       N_LOC - 1).long()]
        h = torch.cat([prof,
                       scal[:, None, :].expand(b, NUM_LEVELS, scal.shape[1]),
                       loc[:, None, :].expand(b, NUM_LEVELS, LOC_DIM)], -1)
        h = F.pad(h, (0, 0, self.seq - NUM_LEVELS, 0))
        skips = []
        for level in range(len(self.mult)):
            res = self.seq >> level
            first = getattr(self, f"enc{res}_conv" if level == 0
                            else f"enc{res}_down")
            h = first(h, cast)
            skips.append(h)
            for i in range(self.nblocks):
                h = getattr(self, f"enc{res}_block{i}")(h, cast)
                skips.append(h)
        for level in reversed(range(len(self.mult))):
            res = self.seq >> level
            if level == len(self.mult) - 1:
                h = getattr(self, f"dec{res}_in0")(h, cast)
                h = getattr(self, f"dec{res}_in1")(h, cast)
            else:
                h = getattr(self, f"dec{res}_up")(h, cast)
            for i in range(self.nblocks + 1):
                h = getattr(self, f"dec{res}_block{i}")(
                    torch.cat([h, skips.pop()], -1), cast)
        h = self.out_conv(F.silu(self.out_norm(h)), cast)
        h = h[:, self.seq - NUM_LEVELS:]
        n = self.n_prof_out
        y = torch.cat([h[:, :, :n].transpose(1, 2).reshape(b, -1),
                       torch.relu(h[:, :, n:]).mean(dim=1)], -1)
        return y * self.prune_mask


def kinds(model: nn.Module) -> dict:
    """Each parameter's kind, for ``common.draw_weights``."""
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "emb_loc":
            out[name] = "embedding"
        elif "norm" in name:
            out[name] = "scale" if leaf == "weight" else "shift"
        else:
            out[name] = "weight" if leaf == "weight" else "bias"
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        m = Model(cfg)
    shapes = {n: tuple(p.shape) for n, p in m.named_parameters()}
    return common.draw_weights(shapes, kinds(m), seed, device)


def build(cfg: dict, weights: dict) -> Model:
    """The reference model on the weights' device, holding copies."""
    dev = next(iter(weights.values())).device
    with torch.device(dev):
        m = Model(cfg)
    m.load_state_dict(weights, strict=True)
    return m


# -- the coupling wrapper ---------------------------------------------------

def v4_to_v5(x: torch.Tensor) -> torch.Tensor:
    """Raw v4 (B, 1525) -> raw v5 (B, 1405): qn = qc + qi, the liquid
    partition from the temperature, the previous-step blocks repacked."""
    return torch.cat([
        x[:, 0:120], x[:, 120:180] + x[:, 180:240],
        common.liquid_fraction(x[:, 0:60]), x[:, 240:840],
        x[:, 840:900] + x[:, 900:960], x[:, 960:1140],
        x[:, 1140:1200] + x[:, 1200:1260], x[:, 1260:1525]], dim=1)


def serve(cfg: dict, weights: dict, norms: dict, x_raw: torch.Tensor,
          cast=common.exact, block: int = 4096) -> torch.Tensor:
    """Raw v4 columns (B, 1525) -> raw tendencies (B, 368): the v5 input
    transform, the U-Net, the stratosphere of q1, qn, u and v zeroed,
    un-scaled, and the cloud tendency split into liquid and ice by the
    temperature after the step, in blocks of ``block`` rows."""
    dev = x_raw.device
    s = cfg["serve"]
    model = build(cfg, weights)
    lay5 = Layout(cfg["varspec"])
    in_t = common.input_transform(lay5, norms, s["transform"], dev)
    mask = torch.ones(lay5.output_len, device=dev)
    for start in (60, 120, 180, 240):          # q1, qn, u, v
        mask[start:start + s["strato_lev_out"]] = 0.0
    inv = torch.as_tensor(1.0 / norms["out_scale"], dtype=torch.float32,
                          device=dev)
    dt = s["dt_seconds"]
    out = []
    with torch.no_grad(), common.no_tf32():
        for i in range(0, x_raw.shape[0], block):
            x = x_raw[i:i + block]
            y = model(in_t(v4_to_v5(x)), cast) * mask * inv
            t, qc, qi = x[:, 0:60], x[:, 120:180], x[:, 180:240]
            qn_new = qc + qi + y[:, 120:180] * dt
            liq = common.liquid_fraction(t + y[:, 0:60] * dt)
            dqc = (liq * qn_new - qc) / dt
            dqi = ((1.0 - liq) * qn_new - qi) / dt
            out.append(torch.cat([y[:, :120], dqc, dqi, y[:, 180:]], 1))
    return torch.cat(out)


# the row block the reference follows a training step in, so that its
# float32 activations at the training cell's B = 8192 hold a small share
# of the card; a batch of ROWS rows or fewer is one block, the whole-batch
# path bit for bit
ROWS = 1024


def train(cfg: dict, weights: dict, norms: dict, batches, cast=common.exact
          ) -> dict:
    """``common.follow_steps`` over the raw (xb, yb) ``batches``, in blocks
    of ``ROWS`` rows."""
    dev = batches[0][0].device
    model = build(cfg, weights)
    lay = Layout(cfg["varspec"])
    tr = cfg["train"]
    in_t = common.input_transform(lay, norms, tr["transform"], dev)
    tgt_t = common.target_transform(lay, norms, tr["transform"], dev)
    params = dict(model.named_parameters())
    with common.no_tf32():
        return common.follow_steps(lambda x: model(x, cast), params, batches,
                                   tr, in_t, tgt_t, ROWS)


def wire_scale(norms: dict) -> torch.Tensor:
    """The out_scale of the 368 wire outputs (float64): the v5 scale, the
    cloud water's for both the liquid and the ice tendency."""
    s = torch.as_tensor(norms["out_scale"], dtype=torch.float64)
    return torch.cat([s[:120], s[120:180], s[120:180], s[180:]])

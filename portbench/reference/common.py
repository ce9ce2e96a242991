"""What the plain references share: the rounding of the control, the
weights drawn from a seed, the input and target transforms, the losses,
the learning-rate schedules, Adam, and the training steps the reference
follows.

Every function is plain PyTorch in float32 with TF32 off (``no_tf32``).
``cast`` is where the program rounds to its compute dtype (bf16): the
reference passes ``exact`` there, and the control passes ``fp8``, which
rounds to the precision one step below the configuration's (e4m3's 3
mantissa bits; the exponent is left unbounded, as a per-tensor scale
would leave it).
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

from ..traffic.varspec import Layout


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """``t`` rounded to nearest even with ``bits`` stored mantissa bits,
    its exponent unbounded; the gradient passes through unchanged, as
    through the program's casts."""
    with torch.no_grad():
        m, e = torch.frexp(t)
        scale = float(2 ** (bits + 1))
        r = torch.ldexp(torch.round(m * scale) / scale, e)
    return t + (r - t).detach()


def fp8(t: torch.Tensor) -> torch.Tensor:
    return round_mantissa(t, 3)


CASTS = {"exact": exact, "fp8": fp8}


@contextmanager
def no_tf32():
    """float32 products and convolutions in full float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- weights ---------------------------------------------------------------

def draw_weights(shapes: dict, kinds: dict, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} for the parameter ``shapes``
    ({name: shape}), drawn from ``seed`` in two calls of one generator on
    the device: a weight ("weight", fan-in first) uniform with variance
    1 / fan-in, so that every layer, the residual branches and the output
    head included, moves the result as a trained network's do; a bias
    0.1 N(0, 1); a norm's scale 1 + 0.1 N(0, 1) and its shift 0.1 N(0, 1);
    an embedding N(0, 1).  ``kinds`` maps a name to one of "weight",
    "bias", "scale", "shift", "embedding"."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    names = sorted(shapes)
    wts = [n for n in names if kinds[n] == "weight"]
    rest = [n for n in names if kinds[n] != "weight"]
    numel = {n: math.prod(shapes[n]) for n in names}
    uni = torch.rand(sum(numel[n] for n in wts), generator=g, device=device)
    nor = torch.randn(sum(numel[n] for n in rest), generator=g,
                      device=device)
    out, off = {}, 0
    for n in wts:
        shape = shapes[n]
        fan_in = math.prod(shape[1:])
        bound = math.sqrt(3.0 / fan_in)
        out[n] = ((uni[off:off + numel[n]] * 2 - 1) * bound).view(shape)
        off += numel[n]
    off = 0
    for n in rest:
        z = nor[off:off + numel[n]].view(shapes[n])
        off += numel[n]
        out[n] = {"bias": 0.1 * z, "scale": 1.0 + 0.1 * z,
                  "shift": 0.1 * z, "embedding": z}[kinds[n]]
    return {n: t.contiguous() for n, t in out.items()}


# -- transforms --------------------------------------------------------------

def load_norms(path: str) -> dict:
    """The normalization file as float64 numpy arrays: inp_sub, inp_div (a
    zero range replaced by 1), out_scale and the cloud rates present."""
    z = np.load(path)
    out = {k: np.asarray(z[k], np.float64) for k in z.files}
    out["inp_div"] = np.where(out["inp_div"] == 0.0, 1.0, out["inp_div"])
    return out


def _first_levels(vec: np.ndarray, slices: dict, names, depth: int,
                  value: float) -> None:
    for v in names:
        if v in slices and depth > 0:
            s = slices[v].start
            vec[s:s + depth] = value


def input_transform(layout: Layout, norms: dict, tcfg: dict, device):
    """fn(raw (B, D) float32) -> normalized (B, D) float32: the cloud
    exponential transform 1 - exp(-lbd q) on the cloud profiles, (x - sub)
    / div, non-finite values to 0, the stratosphere of the clouds pruned,
    the relative humidity clipped to [0, 1.2]."""
    d, sl = layout.input_len, layout.input_slices
    lbd = np.zeros(d)
    if tcfg.get("qn_transform"):
        for name, key in (("state_qn", "lbd_qn"), ("state_q0002", "lbd_qc"),
                          ("state_q0003", "lbd_qi")):
            if name in sl:
                lbd[sl[name]] = norms[key]
    mask = np.ones(d)
    if tcfg.get("qinput_prune"):
        _first_levels(mask, sl, ("state_qn", "state_q0002", "state_q0003"),
                      tcfg["strato_lev"], 0.0)
    lo, hi = np.full(d, -np.inf), np.full(d, np.inf)
    if tcfg.get("input_clip"):
        if not tcfg.get("input_clip_rhonly"):
            raise ValueError("the references clip the relative humidity only")
        lo[sl["state_rh"]], hi[sl["state_rh"]] = 0.0, 1.2

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    sub, div, lbd_t, mask_t = t(norms["inp_sub"]), t(norms["inp_div"]), \
        t(lbd), t(mask)
    cloud = t(lbd > 0) > 0.5
    lo_t, hi_t = t(lo), t(hi)

    def transform(x: torch.Tensor) -> torch.Tensor:
        x = torch.where(cloud, 1.0 - torch.exp(-x * lbd_t), x)
        x = (x - sub) / div
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x)) * mask_t
        return torch.minimum(torch.maximum(x, lo_t), hi_t)

    return transform


def target_transform(layout: Layout, norms: dict, tcfg: dict, device):
    """fn(raw (B, D_out)) -> y * out_scale, non-finite values to 0, the
    stratosphere of ``output_prune_vars`` zeroed."""
    mask = np.ones(layout.output_len)
    if tcfg.get("output_prune"):
        _first_levels(mask, layout.output_slices, tcfg["output_prune_vars"],
                      tcfg["strato_lev_out"], 0.0)
    scale = torch.as_tensor(norms["out_scale"], dtype=torch.float32,
                            device=device)
    mask_t = torch.as_tensor(mask, dtype=torch.float32, device=device)

    def transform(y: torch.Tensor) -> torch.Tensor:
        y = y * scale
        return torch.where(torch.isfinite(y), y, torch.zeros_like(y)) * mask_t

    return transform


# -- losses and schedules -------------------------------------------------

def loss_fn(name: str):
    if name == "mse":
        return lambda p, y: torch.mean((p - y) ** 2)
    if name == "huber":
        def huber(p, y, delta=1.0):
            a = torch.abs(p - y)
            return torch.mean(torch.where(a <= delta, 0.5 * a**2,
                                          delta * (a - 0.5 * delta)))
        return huber
    raise ValueError(f"loss {name!r}")


def learning_rate(sched: dict, step: int) -> float:
    """The learning rate of update ``step`` (0 first)."""
    if sched["name"] == "cosine":
        t = min(step, sched["decay_steps"])
        return sched["init_lr"] * 0.5 * (
            1 + math.cos(math.pi * t / sched["decay_steps"]))
    if sched["name"] == "cyclic_triangular2":
        size = sched["step_size"]
        cycle = math.floor(1 + step / (2 * size))
        x = abs(step / size - 2 * cycle + 1)
        return sched["init_lr"] + (sched["max_lr"] - sched["init_lr"]) * max(
            0.0, 1 - x) / 2 ** (cycle - 1)
    raise ValueError(f"schedule {sched['name']!r}")


def follow_steps(forward, params: dict, batches, train: dict, in_t, tgt_t,
                 rows=None) -> dict:
    """Follow the program's first training steps: for each raw batch (xb,
    yb), the loss of ``forward(in_t(xb))`` against ``tgt_t(yb)``, its
    gradients, and Adam (betas 0.9, 0.999, eps 1e-8 outside the root, bias
    corrected) at ``train``'s schedule.  Where ``rows`` is given, a step's
    loss and gradients are summed over blocks of ``rows`` rows, each
    block's mean weighted by its rows over the batch's: the losses are
    means of per-sample terms and the model mixes no rows, so the blocks
    change only the float32 summation order.  ``params`` ({name: leaf})
    change in place.  Returns {"loss": [each step's], "grad": {name: the
    first step's gradient}, "change": {name: the change over all
    steps}}."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    loss_of = loss_fn(train["loss"])
    start = {n: p.detach().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    for t, (xb, yb) in enumerate(batches):
        for p in params.values():
            p.grad = None
        loss, block = 0.0, rows or len(xb)
        for i in range(0, len(xb), block):
            xs, ys = xb[i:i + block], yb[i:i + block]
            part = loss_of(forward(in_t(xs)), tgt_t(ys)) * (len(xs) / len(xb))
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            if first is None:
                first = {n: p.grad.clone() for n, p in params.items()}
            lr = learning_rate(train["schedule"], t)
            c1, c2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
            for n, p in params.items():
                g = p.grad
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / c2).sqrt_().add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / c1)
    with torch.no_grad():
        change = {n: p.detach() - start[n] for n, p in params.items()}
    return {"loss": losses, "grad": first, "change": change}


def liquid_fraction(t: torch.Tensor) -> torch.Tensor:
    """The liquid share of cloud water: 0 below 253.16 K, 1 above
    273.16 K, linear between."""
    return torch.clamp((t - 253.16) / 20.0, 0.0, 1.0)


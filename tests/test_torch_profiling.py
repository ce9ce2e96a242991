"""The port's profiling helpers (utils.profiling, train.step.StepInfo) on
the CPU: FLOPs of an MLP train step equal the analytic count, kernel 5's
registered formula counts a U-Net's k = 3 chains as the plain
convolutions count, StepInfo leaves the caller's state as it was, and
MetricsLogger writes the JAX logger's rows (times excluded).  Counts are
integers and must be exact."""

import json

import torch

from climsim_tpu.utils.profiling import MetricsLogger as JaxMetricsLogger
from climsim_tpu_torch import get_varspec, load_asset_norms
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.data import transforms as PT
from climsim_tpu_torch.data.synthetic import synthetic_inputs, synthetic_split
from climsim_tpu_torch.models.common import Dense
from climsim_tpu_torch.models.unet import ClimSimUNet
from climsim_tpu_torch.ops import unet_infer
from climsim_tpu_torch.train import recipes as PR
from climsim_tpu_torch.train.step import StepInfo
from climsim_tpu_torch.utils import profiling as PF

V1 = get_varspec("v1")
V5 = get_varspec("v5")


def _mlp(b=64):
    x, y = synthetic_split(V1, b, load_default_grid(), seed=0)
    tr = PR.mlp_trainer(V1, load_asset_norms("v1"), None, 0,
                        hidden=(32, 24), compute_dtype=torch.float32,
                        device="cpu")
    return tr, torch.from_numpy(x), torch.from_numpy(y)


def test_mlp_step_flops_are_the_analytic_count():
    """One Adam step of mlp_trainer at B = 64: 2 B in out a Dense layer
    forward, as much for dW, and as much for dx but at the first layer,
    whose input needs no gradient: 6 B sum(in out) - 2 B in_0 out_0.
    StepInfo counts it on a copy: the caller's step, weights, optimizer
    and generator do not move."""
    tr, xb, yb = _mlp()
    layers = [m.weight.shape for m in tr.model.modules()
              if isinstance(m, Dense)]
    first = tr.model.trunk.layers[0].weight.shape
    want = 6 * 64 * sum(o * i for o, i in layers) - 2 * 64 * first[0] * first[1]
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    rng = tr.state.rng.get_state()
    info = StepInfo.from_step(tr.train_step, tr.state, xb, yb)
    assert info.flops_per_step == want
    assert info.peak_memory_bytes is None        # no card here
    assert tr.state.step == 0 and not tr.state.opt_state.state
    assert torch.equal(tr.state.rng.get_state(), rng)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    c = PF.cost_analysis(tr.train_step, tr.state, xb, yb)
    assert c["flops"] == want and tr.state.step == 1
    assert "bytes accessed" not in c


def test_kernel5_formula_counts_the_unet_chains():
    """A small U-Net's forward through the engine (kernel 5's operator
    for every GroupNorm -> silu -> conv3 chain): the total equals the
    plain engine's, whose chains are F.conv1d, and the operator's share
    is 2 B L C_in C_out 3 summed over the chains it ran; without the
    formula the count would lose exactly that share."""
    model = ClimSimUNet(V5, model_channels=16, channel_mult=(1, 2),
                        num_blocks=1, attn_resolutions=(), fused_gn_conv=True)
    model.eval()
    x = synthetic_inputs(V5, 16, load_default_grid(), seed=0)
    xn = PT.make_input_transform(V5, load_asset_norms("v5"),
                                 PT.v5_online_config(),
                                 device="cpu")(torch.from_numpy(x))
    calls = []
    real = unet_infer.fused_gn_silu_conv3

    def record(x, gamma, beta, w, b):
        calls.append((*x.shape, w.shape[2]))
        return real(x, gamma, beta, w, b)

    unet_infer.fused_gn_silu_conv3 = record
    try:
        fused = PF.cost_analysis(unet_infer.unet_apply_fused, model, xn)
    finally:
        unet_infer.fused_gn_silu_conv3 = real
    plain = PF.cost_analysis(lambda: unet_infer.unet_apply_fused(
        model, xn, fused=False))
    assert len(calls) > 4
    share = sum(2 * b * l * c * o * 3 for b, l, c, o in calls)
    op = [v for k, v in fused["flops_by_op"].items()
          if "fused_gn_silu_conv3" in k]
    assert op == [share]
    assert fused["flops"] == plain["flops"] > share


def test_trace_and_time_fn(tmp_path):
    f = torch.nn.Linear(8, 8)
    x = torch.randn(4, 8)
    with PF.trace(str(tmp_path / "tr")):
        f(x)
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert json.loads(files[0].read_text())["traceEvents"]
    assert PF.time_fn(f, x, iters=5, warmup=1) > 0


def test_metrics_logger_writes_the_jax_rows(tmp_path):
    rows = [(0, dict(loss=1.5, lr=1e-3)), (1, dict(loss=1.25)),
            (2, dict(loss=1.0, val=2.0))]
    ours = PF.MetricsLogger(str(tmp_path / "p"), name="run")
    theirs = JaxMetricsLogger(str(tmp_path / "j"), name="run")
    for step, m in rows:
        ours.log(step, **m)
        theirs.log(step, **m)

    def jsonl(d):
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in (tmp_path / d / "run.jsonl").read_text()
                .splitlines()]

    assert jsonl("p") == jsonl("j") and len(jsonl("p")) == 3

    def csv(path):
        lines = [ln.split(",") for ln in open(path).read().splitlines()]
        t = lines[0].index("time")
        return [ln[:t] + ln[t + 1:] for ln in lines]

    assert csv(ours.to_csv()) == csv(theirs.to_csv())
    empty = PF.MetricsLogger(str(tmp_path / "e"))
    assert empty.to_csv().endswith("run.csv")

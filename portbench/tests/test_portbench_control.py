"""The comparison that decides ``correct`` fails where it must: the
control (the reference at fp8 in the program's place) fails a number of
each cell, and a run with its timed path broken underneath comes out not
correct, once for each fault the cell can have (one card: no exchange
between cards).  The card-marked tests read the control at the cells'
own sizes on the card."""

import pytest
import torch

from portbench import calibrate, harness
from portbench.drivers import serve as S
from portbench.drivers import train as T
from portbench.tests.conftest import cpu_context, tiny_cell

TRAIN = ["unet_v5.train_b8192", "mlp_v1.train_b32768"]


def fails(readings: dict, limits: dict) -> list:
    """The numbers compared (those with a limit) that exceed it."""
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("name", TRAIN)
def test_the_control_fails_a_training_cell(name):
    cell = tiny_cell(name)
    out = calibrate.train_seed(cpu_context(cell, seed=2**31 + 201), True)
    assert fails(out["control"], cell.limits)
    assert fails(out["half_batch"], cell.limits)


def test_the_control_fails_the_served_cell():
    cell = tiny_cell("unet_v5.serve_c8")
    out = calibrate.serve_seed(cpu_context(cell, seed=2**31 + 202), True)
    assert fails(out["control"], cell.limits)


def run_with(monkeypatch, name, module, fault):
    """A run of the tiny cell with ``fault`` wrapped round what ``build``
    returns first (the trainer or the wrapper)."""
    cell = tiny_cell(name)
    real = module.build

    def broken(*a, **k):
        made = real(*a, **k)
        return (fault(made[0]),) + tuple(made[1:])

    monkeypatch.setattr(module, "build", broken)
    return cell.driver.run(cpu_context(cell, seed=2**31 + 203))


def unchanged(tr):
    """A step that returns its state unchanged."""
    def step(state, xb, yb):
        loss, _ = tr.loss_fn(state.params, None, xb, yb)
        return state, {"loss": loss.detach()}
    tr.train_step = step
    return tr


def half_batch(tr):
    """Half of each batch left out, the mean taken over the rest."""
    real = tr.train_step
    tr.train_step = lambda state, xb, yb: real(state, xb[:len(xb) // 2],
                                               yb[:len(yb) // 2])
    return tr


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in TRAIN for f in (unchanged, half_batch)],
    ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_broken_training_step_is_not_correct(monkeypatch, name, fault):
    res = run_with(monkeypatch, name, T, fault)
    assert res["correct"] is False
    assert fails({k: c["value"] for k, c in res["checks"].items()},
                 {k: c["limit"] for k, c in res["checks"].items()})


def altered(wrapper):
    """Each call's first answer replaced by its second's."""
    def fn(x):
        y = wrapper(x).clone()
        y[0] = y[1]
        return y
    return fn


def half_rows(wrapper):
    """Half of each call's rows left out: zeros answered for them."""
    def fn(x):
        n = x.shape[0] // 2
        return torch.cat([wrapper(x[:n]), torch.zeros_like(
            wrapper(x[:x.shape[0] - n]))])
    return fn


@pytest.mark.parametrize("fault", [altered, half_rows],
                         ids=["altered", "half_rows"])
def test_a_broken_served_path_is_not_correct(monkeypatch, fault):
    res = run_with(monkeypatch, "unet_v5.serve_c8", S, fault)
    assert res["correct"] is False
    assert res["checks"]["reply_gap"]["value"] > \
        res["checks"]["reply_gap"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("name", TRAIN + ["unet_v5.serve_c8"])
def test_the_control_at_the_cells_size_on_the_card(card, name):
    cell = harness.Cell(name)
    from portbench.run import Context
    import time

    ctx = Context(cell, 2**31 + 301, 4.0, False, device=card,
                  t_process=time.perf_counter())
    fn = calibrate.train_seed if cell.mix["driver"] == "train" \
        else calibrate.serve_seed
    out = fn(ctx, True)
    assert not fails(out["program"], cell.limits)
    assert fails(out["control"], cell.limits)

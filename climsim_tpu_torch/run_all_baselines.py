"""Train all six offline baselines on the synthetic split and write the
headline metric tables (the main_figure_generation flow, end to end).

The port's entry for ``scripts/run_all_baselines.py``:

    python -m climsim_tpu_torch.run_all_baselines [--epochs 12]
        [--n-train 18432] [--n-score 4608] [--out PATH] [--device cuda]

writes ``docs/SYNTHETIC_RESULTS.torch.md`` (never the JAX script's
``docs/SYNTHETIC_RESULTS.md``).  ``train_and_score`` is the shared core of
this entry, ``make_offline_figures`` and ``run_real_baselines``.

On the card the single models train through ``DeviceResidentLoader`` and
its epoch runner (the JAX script's TPU branch), on the CPU through
``BatchLoader``; the RPN ensemble through ``BootstrapLoader`` on both.
The port's steps never wait for the card: every timing ends with a host
read of the last loss.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np

# the JAX script's batches (scripts/run_all_baselines.py:39, :84-95)
BATCH = 1024
CNN_BATCH = 512
SCORE_BATCH = 4096
NUM_SAMPLES = 32
SAMPLE_SEED = 9          # the JAX script's PRNGKey(9)
MIN_TRAIN_ROWS = 1280    # BootstrapLoader's subsets (0.8 n) hold a batch


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name(0)


def _host_loss(loss) -> float:
    """A device loss read on the host: the wait for the card."""
    return float(loss.detach().double().cpu())


def train_and_score(spec, grid, stats, x_tr, y_tr, x_sc, y_sc, epochs=12,
                    device="cuda"):
    """Train all six offline baselines on (x_tr, y_tr) and score them on
    (x_sc, y_sc) in the common W/m^2 metric space; returns (tables,
    train_info, preds, samples) as the JAX function does.  ``train_info``
    also holds the loss of each model's first epoch of its last stage
    (``first_loss``: HSR's first NLL epoch, the RPN's first step),
    whether its epochs ran through the resident loader's epoch runner
    (``fused``), its training steps (``steps``) and the batches that ran
    its input transform outside training (``transform_calls``:
    prediction batches and sample draws)."""
    import torch

    from .data.pipeline import (BatchLoader, BootstrapLoader,
                                DeviceResidentLoader)
    from .data.transforms import make_target_transform
    from .eval.scoring import offline_score
    from .train import recipes, rpn_recipe
    from .train.loop import run_epoch

    n_train, n_score = x_tr.shape[0], x_sc.shape[0]
    if n_train < MIN_TRAIN_ROWS:
        raise ValueError(f"{n_train} training rows: the RPN draws batches "
                         f"of {BATCH} from bootstrap subsets of 80% of the "
                         f"rows, so at least {MIN_TRAIN_ROWS}")
    on_card = torch.device(device).type == "cuda"
    Loader = DeviceResidentLoader if on_card else BatchLoader
    rng = 0
    preds, samples, train_info = {}, {}, {}
    n_predict = -(-n_score // SCORE_BATCH)

    def train_generic(name, tr, batch=BATCH, n_epochs=epochs,
                      stage2_after=None):
        loader = Loader(x_tr, y_tr, batch, seed=0, device=device)
        state = tr.state
        t0 = time.time()
        fused = (hasattr(loader, "make_epoch_runner")
                 and stage2_after is None)
        if fused:
            # the epochs through the epoch runner, as two equal halves:
            # the first is the warm-up, the second is timed
            run = loader.make_epoch_runner(tr.train_step)
            half = n_epochs // 2
            if half == 0:
                t1 = time.time()
                state, m = run(state, n_epochs)
                loss = _host_loss(m["loss"][-1])
                sps = (n_epochs * loader.steps_per_epoch * batch
                       / max(time.time() - t1, 1e-9))
                first = _host_loss(m["loss"][0])
            else:
                state, m = run(state, half)
                _host_loss(m["loss"][-1])
                first = _host_loss(m["loss"][0])
                t1 = time.time()
                state, m = run(state, half)
                loss = _host_loss(m["loss"][-1])
                sps = (half * loader.steps_per_epoch * batch
                       / max(time.time() - t1, 1e-9))
                rem = n_epochs - 2 * half
                if rem > 0:
                    state, m = run(state, rem)
                    loss = _host_loss(m["loss"][-1])
        else:
            for ep in range(n_epochs):
                step = tr.train_step
                if stage2_after is not None and ep >= stage2_after:
                    step = tr.stage2_step
                state, loss, sps = run_epoch(step, state, loader)
                if ep == 0 or ep == stage2_after:
                    first = loss
        calls = n_predict
        preds[name] = tr.predict(state.params, x_sc, SCORE_BATCH)
        if tr.sample is not None:
            with torch.no_grad():
                samples[name] = tr.sample(
                    state.params, torch.as_tensor(x_sc), SAMPLE_SEED,
                    NUM_SAMPLES).float().cpu().numpy()
            calls += 1
        train_info[name] = dict(loss=loss, sps=sps,
                                secs=round(time.time() - t0, 1),
                                first_loss=first, fused=fused,
                                steps=n_epochs * loader.steps_per_epoch,
                                transform_calls=calls)
        print(f"{name}: loss {loss:.4f} ({sps:,.0f} samples/s)", flush=True)
        return state

    train_generic("MLP", recipes.mlp_trainer(
        spec, stats, (x_tr, y_tr), rng, steps_per_epoch=n_train // BATCH,
        device=device))
    train_generic("ED", recipes.ed_trainer(
        spec, stats, (x_tr, y_tr), rng, steps_per_epoch=n_train // BATCH,
        device=device))
    train_generic("CNN", recipes.cnn_trainer(
        spec, stats, (x_tr, y_tr), rng,
        steps_per_epoch=n_train // CNN_BATCH, device=device),
        batch=CNN_BATCH, n_epochs=max(epochs // 2, 3))
    train_generic("HSR", recipes.hsr_trainer(
        spec, stats, (x_tr, y_tr), rng, device=device),
        stage2_after=epochs // 3)
    train_generic("cVAE", recipes.cvae_trainer(
        spec, stats, (x_tr, y_tr), rng, device=device))

    # RPN ensemble
    tr = rpn_recipe.rpn_trainer(spec, stats, x_tr, rng, ensemble_size=8,
                                hidden=(256, 256), device=device)
    bl = BootstrapLoader(x_tr, y_tr, BATCH, 8,
                         steps_per_epoch=n_train // BATCH, seed=0,
                         device=device)
    t0 = time.time()
    n_rows = 0
    first = None
    for ep in range(epochs):
        for xb, yb in bl:
            losses = tr.train_step(xb, yb)
            first = losses if first is None else first
            n_rows += xb.shape[-2]
    rpn_loss = float(losses.double().mean().cpu())   # the wait for the card
    rpn_secs = time.time() - t0
    post = []
    for s in range(0, n_score, SCORE_BATCH):
        post.append(tr.posterior(torch.as_tensor(
            x_sc[s:s + SCORE_BATCH]).to(device)).float().cpu().numpy())
    post = np.concatenate(post)
    preds["RPN"] = post.mean(axis=-1)
    samples["RPN"] = post
    train_info["RPN"] = dict(loss=rpn_loss, sps=n_rows / max(rpn_secs, 1e-9),
                             secs=round(rpn_secs, 1),
                             first_loss=float(first.double().mean().cpu()),
                             fused=False,
                             steps=epochs * bl.steps_per_epoch,
                             transform_calls=n_predict)
    print(f"RPN: loss {train_info['RPN']['loss']:.4f}", flush=True)

    # score everything
    tgt = make_target_transform(spec, stats, device="cpu")(
        torch.as_tensor(y_sc)).numpy()
    x_sc_n = (x_sc - stats.inp_sub) / stats.inp_div
    tables, _ = offline_score(spec, grid, stats, x_sc_n, tgt, preds,
                              samples)
    return tables, train_info, preds, samples


def metric_tables_markdown(tables, reference=None):
    """Per-metric markdown tables; with ``reference`` (variable ->
    {metric: {model: value}} from BASELINE.md) a 'ref MODEL' column pair
    is appended for side-by-side comparison."""
    lines = []
    models = list(tables)
    for metric in ("MAE", "RMSE", "R2", "CRPS"):
        have = [m for m in models
                if any(metric in row for row in tables[m].values())]
        if not have:
            continue
        rows = [v for v in tables[have[0]]
                if metric in tables[have[0]][v]]
        header = list(have)
        if reference:
            header += [f"ref {m}" for m in have]
        lines += [f"## {metric}", "",
                  "| Variable | " + " | ".join(header) + " |",
                  "|---|" + "---|" * len(header)]
        for v in rows:
            vals = [f"{tables[m][v][metric]:.3f}" for m in have]
            if reference:
                ref_v = reference.get(v, {}).get(metric, {})
                vals += [(f"{ref_v[m]:.3f}" if m in ref_v else "--")
                         for m in have]
            lines.append(f"| {v} | " + " | ".join(vals) + " |")
        lines.append("")
    return lines


def training_table_markdown(train_info):
    lines = ["## Training", "",
             "| Model | final loss | samples/s | wall (s) |",
             "|---|---|---|---|"]
    for m, info in train_info.items():
        lines.append(f"| {m} | {info['loss']:.4f} | "
                     f"{info['sps']:,.0f} | {info['secs']} |")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--n-train", type=int, default=48 * 384)
    ap.add_argument("--n-score", type=int, default=12 * 384)
    ap.add_argument("--out", default="docs/SYNTHETIC_RESULTS.torch.md")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .data.synthetic import synthetic_split
    from .grid import load_default_grid
    from .norms import compute_norms_from_data
    from .varspec import get_varspec

    n_train, n_score, epochs = args.n_train, args.n_score, args.epochs
    spec = get_varspec("v1")
    grid = load_default_grid()
    x, y = synthetic_split(spec, n=n_train + n_score, grid=grid, seed=0,
                           noise=0.03)
    stats = compute_norms_from_data(spec, x[:n_train], y[:n_train])
    tables, train_info, preds, samples = train_and_score(
        spec, grid, stats, x[:n_train], y[:n_train],
        x[n_train:], y[n_train:], epochs=epochs, device=args.device)

    card = card_line(args.device)
    lines = [
        "# Synthetic-split baseline results (PyTorch port)",
        "",
        "All six offline baselines trained end to end on the synthetic v1 "
        "split and scored with the weighted metric engine "
        f"(device: {card}; {epochs} epochs, {n_train:,} train / "
        f"{n_score:,} scoring samples).  These numbers validate the "
        "*machinery* (training, sampling, weighting, CRPS); skill against "
        "BASELINE.md requires the real dataset.  Produced by `python -m "
        "climsim_tpu_torch.run_all_baselines`.",
        "",
    ]
    lines += metric_tables_markdown(tables)
    lines += training_table_markdown(train_info)
    lines += [
        "",
        "### Reading these numbers",
        "",
        f"samples/s and wall were measured on {card}.  On the card the "
        "single models whose epochs run through the resident loader's "
        "epoch runner (MLP, ED, CNN, cVAE) are timed on the second of two "
        "equal halves of their epochs (the first is the warm-up); HSR "
        "changes its step at its second stage and runs epoch by epoch, "
        "timed on its last epoch; the RPN over all its epochs.  Every "
        "timing ends with a host read of the last loss.  wall includes "
        "the warm-up, prediction and sampling.",
        "",
        "ED and CNN sit near zero skill *by construction of the synthetic "
        "data*: the targets come from a dense random map over all 124 "
        "features, which a 5-dim ED bottleneck cannot represent and a "
        "vertically-local CNN (k=3 convs over levels) is mismatched to.  "
        "Skill comparisons belong to the real dataset.",
    ]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")
    return dict(tables=tables, train_info=train_info, preds=preds,
                samples=samples, out=args.out)


if __name__ == "__main__":
    main()

"""Online coupling demo: train a v5 model, wrap it, export it, roll it out.

The port of ``examples/online_coupling.py``, the framework equivalent of
the online_testing workflow: train (briefly), a wrapper with fused
physics constraints (the input transform and constraint-head kernels),
a ``torch.export`` program, a multi-step hybrid rollout, and online
diagnostics -- all on synthetic data.

    python -m climsim_tpu_torch.online_coupling [--steps 12]
        [--train-steps 20] [--export wrapper.pt2] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def run_coupling(steps: int = 12, train_steps: int = 20,
                 export: str | None = None, device="cuda") -> dict:
    """The demo on ``device``; prints as the JAX example does and returns
    the online diagnostics."""
    from .data.synthetic import synthetic_split
    from .eval import online_diags as D
    from .grid import load_default_grid
    from .norms import compute_norms_from_data
    from .online import wrapper as W
    from .online.driver import HybridDriver, initial_state
    from .train import recipes
    from .varspec import get_varspec

    spec5 = get_varspec("v5")
    spec4 = get_varspec("v4")
    grid = load_default_grid()

    # 1. (briefly) train a small coupling-grade model on synthetic pairs;
    # norms computed from the data itself (swap in load_asset_norms("v5")
    # when training on the real dataset)
    x, y = synthetic_split(spec5, n=4 * 384, grid=grid, seed=0)
    x[:, spec5.input_slices["icol"]] = (
        np.arange(x.shape[0]) % 384 + 1)[:, None]
    # qn_transform=True fits the cloud exponential-transform rate and
    # computes the qn sub/div in transformed space (the wrapper chain)
    stats = compute_norms_from_data(spec5, x, y, qn_transform=True)
    tr = recipes.online_mlp_trainer(spec5, stats, (x, y), 0, hidden=(256,),
                                    steps_per_epoch=train_steps,
                                    device=device)
    xd, yd = (torch.from_numpy(a).to(device) for a in (x, y))
    state = tr.state
    for i in range(train_steps):
        s = (i * 256) % (x.shape[0] - 256)
        state, m = tr.train_step(state, xd[s:s + 256], yd[s:s + 256])
    loss = float(m["loss"])
    print(f"trained {train_steps} steps, loss {loss:.4f}")

    # 2. wrap: raw v4 state in -> raw (B, 368) tendencies out
    model = tr.model.eval()
    wrap = W.make_wrapper(lambda xn: model(xn), stats, device=device)
    if export:
        W.export_aot(wrap, 384, spec4.input_len, export, device=device)
        print(f"exported the torch.export wrapper to {export}")

    with torch.inference_mode():
        # 3. hybrid rollout: step 384 host columns with emulator tendencies
        x0 = synthetic_split(spec4, n=384, grid=grid, seed=3)[0]
        driver = HybridDriver(wrap, grid)
        final, traj = driver.rollout(initial_state(x0, device=device), steps)
    traj = {k: v.cpu().numpy() for k, v in traj.items()}
    t_traj, qn_traj, precc = traj["t"], traj["qn"], traj["precc"]
    print(f"rollout: {steps} steps x 384 columns, "
          f"T range [{t_traj.min():.1f}, {t_traj.max():.1f}] K")

    # 4. online diagnostics -- for a briefly-trained toy model these
    # *should* report drift/instability; that detection is their job
    # (a coupling-grade model holds T within a few K over a month)
    ref = np.repeat(t_traj[:1], t_traj.shape[0], axis=0)  # persistence ref
    out = {"train_loss": loss,
           "t_rmse_vs_persistence": D.weighted_rmse(t_traj, ref, grid),
           "precip": D.precip_stats(precc, grid),
           "microphysics": D.microphysics_checks(qn_traj, t_traj, precc),
           "water_res_abs_mean": np.abs(traj["water_res"]).mean(axis=1),
           "t_drift": D.drift(t_traj, grid)}
    print("T drift vs persistence (weighted RMSE):",
          round(out["t_rmse_vs_persistence"], 4))
    print("precip stats:", out["precip"])
    print("microphysics:", out["microphysics"])
    print(f"water-budget residual |mean| per step: "
          f"{out['water_res_abs_mean'].round(6).tolist()}")
    stable = abs(out["t_drift"]) < 10.0
    print(f"stability verdict: {'stable' if stable else 'UNSTABLE'} "
          "(expected UNSTABLE for an undertrained demo model)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=12,
                    help="rollout steps (1200 s each)")
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--export", help="path to save the torch.export wrapper")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run_coupling(args.steps, args.train_steps, args.export,
                        args.device)


if __name__ == "__main__":
    main()

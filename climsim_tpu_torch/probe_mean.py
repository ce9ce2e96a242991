"""Diagnose the coupled T/Q/U bias under the systematic-physics oracle.

The port of ``scripts/probe_mean.py``.  Loads the params and stats cached
by an ``online_eval --cache ...`` run -- the port's
(``params_*.torch.pkl``) or the JAX script's (``params_*.pkl``, a flax
tree, through ``utils.migrate.port_flax_unet``) -- rebuilds the identical
oracle + wrapper pair and separates the two candidate failure modes:

  (a) SUPERVISED mean error: per-level mean of (model - oracle) tendency
      over on-attractor oracle states.  The coupled equilibrium offset is
      ~tau x this error; if it is a sizeable fraction of the oracle's
      mean profile, the model never learned the systematic physics.
  (b) COUPLED feedback: if (a) is small but the hybrid still sits far
      from the ensemble, the bias comes from the closed loop (the model
      is evaluated off-manifold on its own biased states).

Usage: python -m climsim_tpu_torch.probe_mean <params.pkl> <stats.npz>
       [--oracle-mean 3] [--spinup-days 30] [--channels 64]
       [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .online_eval import (STEPS_PER_DAY, _load_params,
                          build_balanced_forcing, make_oracle_wrapper)

SEG = 540   # rollout segment length, in steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("params")
    ap.add_argument("stats")
    ap.add_argument("--oracle-mean", type=float, default=3.0)
    ap.add_argument("--oracle-scale", type=float, default=0.1)
    ap.add_argument("--oracle-gain", type=float, default=64.0)
    ap.add_argument("--tau-days", type=float, default=2.0)
    ap.add_argument("--diurnal", type=float, default=1.5)
    ap.add_argument("--spinup-days", type=float, default=30.0)
    ap.add_argument("--hybrid-days", type=float, default=30.0)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from . import physics
    from .data.synthetic import synthetic_inputs
    from .grid import load_default_grid
    from .norms import NormStats
    from .online import wrapper as W
    from .online.driver import HybridDriver, initial_state
    from .train import recipes
    from .varspec import get_varspec

    dev = torch.device(args.device)
    spec5, spec4 = get_varspec("v5"), get_varspec("v4")
    grid = load_default_grid()
    ncol = grid.ncol

    oracle_wrap, oracle_v5, fit_std, mean_prof = make_oracle_wrapper(
        spec5, spec4, tend_scale=args.oracle_scale, gain=args.oracle_gain,
        mean_gain=args.oracle_mean, device=dev)
    sl_icol5 = spec5.input_slices["icol"]
    x_std = synthetic_inputs(spec5, 4 * ncol, grid, seed=0)
    x_std[:, sl_icol5] = (np.arange(x_std.shape[0]) % ncol + 1)[:, None]
    fit_std(x_std)

    x0 = synthetic_inputs(spec4, ncol, grid, seed=3)
    s_clim = initial_state(x0, grid, device=dev)
    tau_sec = args.tau_days * STEPS_PER_DAY * physics.DT_TIMESTEP
    # the identical balanced forcing as the eval -- shared constructor
    forcing = build_balanced_forcing(
        s_clim, mean_prof, args.tau_days, args.diurnal, grid, dev)
    oracle_driver = HybridDriver(oracle_wrap, grid, dyn_forcing=forcing)

    # stats + params from the cached run
    blob = np.load(args.stats)
    stats = NormStats(inp_sub=blob["sub"], inp_div=blob["div"],
                      out_scale=blob["osc"], lbd_qn=blob["lbd"])
    xb0 = torch.as_tensor(synthetic_inputs(spec5, 256, grid, seed=5),
                          device=dev)
    with torch.no_grad():
        yb0 = oracle_v5(xb0)
    tr = recipes.unet_trainer(
        spec5, stats, (xb0, yb0), 0, steps_per_epoch=1,
        model_kw=dict(model_channels=args.channels, channel_mult=(1, 2, 2),
                      num_blocks=2, attn_resolutions=(16,),
                      output_prune=True), device=dev)
    model = tr.model
    _load_params(args.params, model)
    model.eval()
    hybrid_wrap = W.make_wrapper(lambda xn: model(xn), stats,
                                 W.WrapperConfig(input_version="v4"),
                                 device=dev)
    hybrid_driver = HybridDriver(hybrid_wrap, grid, dyn_forcing=forcing)

    seg = SEG
    with torch.no_grad():
        # --- spin the TRUE system onto its attractor --------------------
        s = initial_state(x0, grid, device=dev)
        spin = int(round(args.spinup_days * STEPS_PER_DAY / seg))
        for k in range(spin):
            s, _ = oracle_driver.rollout(s, seg, start_step=k * seg)
        s_attr = s
        print(f"spun {spin * seg} oracle steps", flush=True)

        # --- (a) supervised mean error on on-attractor states -----------
        _, traj = oracle_driver.rollout(s_attr, seg, collect_features=True,
                                        start_step=spin * seg)
        x4 = traj["x4"].reshape(-1, spec4.input_len)
        del traj
        sel = np.random.default_rng(0).choice(len(x4), 4096, replace=False)
        xb = x4[torch.as_tensor(sel, device=dev)].to(torch.float32)
        del x4
        y_or = oracle_wrap(xb).cpu().numpy()
        y_md = hybrid_wrap(xb).cpu().numpy()

    names = {"ptend_t": (slice(0, 60), "K/s"),
             "ptend_q0001": (slice(60, 120), "kg/kg/s"),
             "ptend_u": (slice(240, 300), "m/s/s")}
    print("\n(a) supervised mean-tendency error (on-attractor):")
    for v, (sl, unit) in names.items():
        tm = mean_prof.get(v, np.zeros(60))
        err = (y_md[:, sl] - y_or[:, sl]).mean(0)
        i = int(np.abs(tm).argmax())
        print(f"  {v:13s} peak true-mean {tm[i]:+.3e} {unit} @lev {i}; "
              f"model-oracle mean err @lev {i}: {err[i]:+.3e} "
              f"(tau*err = {tau_sec * err[i]:+.3f}); "
              f"max|err| {np.abs(err).max():.3e} "
              f"@lev {int(np.abs(err).argmax())} "
              f"(tau*max = {tau_sec * np.abs(err).max():.3f})")

    # --- (b) coupled equilibrium bias ------------------------------------
    n_hyb = int(round(args.hybrid_days * STEPS_PER_DAY / seg))
    with torch.no_grad():
        sh = so = s_attr
        for k in range(n_hyb):
            sh, htraj = hybrid_driver.rollout(sh, seg,
                                              start_step=(spin + k) * seg)
        for k in range(n_hyb):
            so, otraj = oracle_driver.rollout(so, seg,
                                              start_step=(spin + k) * seg)

        def lev_mean(traj, k):   # last segment's time + column mean
            return traj[k].double().mean((0, 1)).cpu().numpy()

        th, to = lev_mean(htraj, "t"), lev_mean(otraj, "t")
        qh, qo = lev_mean(htraj, "q1"), lev_mean(otraj, "q1")
        uh, uo = lev_mean(htraj, "u"), lev_mean(otraj, "u")
    print(f"\n(b) coupled per-level state bias after "
          f"{args.hybrid_days:g} d (hybrid - oracle run):")
    for nm, h, o in (("T [K]", th, to), ("q1", qh, qo), ("u", uh, uo)):
        d = h - o
        i = int(np.abs(d).argmax())
        print(f"  {nm:6s} max|bias| {np.abs(d).max():.4f} @lev {i} "
              f"(hybrid {h[i]:.5g} vs oracle {o[i]:.5g}); "
              f"rms {np.sqrt((d ** 2).mean()):.4f}")
    # where taper is active vs not
    print("  T bias by region: lev<16 {:.3f}, 16-23 {:.3f}, >=24 {:.3f}"
          .format(*[float(np.abs(th - to)[a:b].mean())
                    for a, b in ((0, 16), (16, 24), (24, 60))]))


if __name__ == "__main__":
    main()

"""Hybrid-loop harness: step host columns with emulator tendencies.

The counterpart of ``climsim_tpu.online.driver``.  The real consumer of a
coupling wrapper is the E3SM-MMF host model (online_testing/README.md
section 5).  This module reproduces the *loop contract* on the device so
coupled behavior -- stability, drift, conservation -- can be tested and
timed without E3SM:

  every dt=1200 s:  raw column state -> wrapper -> (B, 368) tendencies
                    -> state += tendency * dt -> derived features refresh
                    (RH, liq_partition, prvphy <- this step's physics,
                    tm_* <- previous step, dyn forcing from a prescribed
                    host-dynamics function)

The JAX module runs a rollout as one ``lax.scan``.  Here it is a Python
loop over steps, and nothing in the loop waits on the card: no
``.item()``, ``.cpu()`` or numpy, so the host issues the steps ahead of
the device.  The trajectory stays on the state's device until the caller
moves it.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import physics
from ..grid import Grid, load_default_grid
from ..varspec import get_varspec


@dataclass(frozen=True)
class ColumnState:
    """Raw per-column prognostic + memory state for the v4 feature set."""

    t: torch.Tensor       # (B, 60) K
    q1: torch.Tensor      # (B, 60) specific humidity
    qc: torch.Tensor      # (B, 60) cloud liquid
    qi: torch.Tensor      # (B, 60) cloud ice
    u: torch.Tensor       # (B, 60)
    v: torch.Tensor       # (B, 60)
    scalars: torch.Tensor  # (B, S) static surface scalars in v4 tail order
    prvphy: torch.Tensor   # (B, 5, 60) previous physics tendencies (t,q1,q2,q3,u)
    tm_prvphy: torch.Tensor  # (B, 5, 60) the step before
    dyn: torch.Tensor     # (B, 3, 60) current dynamics forcing (t, q0, u)
    tm_dyn: torch.Tensor  # (B, 3, 60) previous dynamics forcing


def map_state(fn: Callable, *states: ColumnState) -> ColumnState:
    """ColumnState whose every field is ``fn`` of the states' fields (the
    counterpart of ``jax.tree.map`` over states)."""
    return ColumnState(**{f.name: fn(*(getattr(s, f.name) for s in states))
                          for f in dataclasses.fields(ColumnState)})


def stack_states(states) -> ColumnState:
    """Member states -> one state whose fields carry a leading member axis,
    the input of ``HybridDriver.rollout_ensemble``."""
    return map_state(lambda *a: torch.stack(a), *states)


def initial_state(x_v4_raw, grid: Grid | None = None,
                  device="cuda") -> ColumnState:
    """Build a ColumnState on ``device`` from a raw v4 feature batch (numpy
    or a tensor, e.g. synthetic), in its dtype."""
    spec = get_varspec("v4")
    sl = spec.input_slices
    # a private copy: the state's fields are views of it
    x = torch.as_tensor(x_v4_raw).to(device=device, copy=True)
    prof = lambda n: x[:, sl[n]]
    scal_names = [v for v in spec.inputs if spec.input_slices[v].stop -
                  spec.input_slices[v].start == 1]
    scalars = torch.cat([x[:, sl[n]] for n in scal_names], dim=1)
    stack = lambda names: torch.stack([prof(n) for n in names], dim=1)
    return ColumnState(
        t=prof("state_t"), q1=physics_q1_from_rh(x, spec, grid, device),
        qc=prof("state_q0002"), qi=prof("state_q0003"),
        u=prof("state_u"), v=prof("state_v"),
        scalars=scalars,
        prvphy=stack(["state_t_prvphy", "state_q0001_prvphy",
                      "state_q0002_prvphy", "state_q0003_prvphy",
                      "state_u_prvphy"]),
        tm_prvphy=stack(["tm_state_t_prvphy", "tm_state_q0001_prvphy",
                         "tm_state_q0002_prvphy", "tm_state_q0003_prvphy",
                         "tm_state_u_prvphy"]),
        dyn=stack(["state_t_dyn", "state_q0_dyn", "state_u_dyn"]),
        tm_dyn=stack(["tm_state_t_dyn", "tm_state_q0_dyn",
                      "tm_state_u_dyn"]),
    )


def physics_q1_from_rh(x_v4_raw, spec, grid: Grid | None = None,
                       device="cuda") -> torch.Tensor:
    """v4 carries RH, not q1; recover q1 = rh * qsat(t, pmid) with the real
    hybrid-sigma mid-level pressure (data_utils.py:1049-1052), in the
    dtype of ``x_v4_raw``, on ``device``."""
    grid = grid or load_default_grid()
    x = torch.as_tensor(x_v4_raw, device=device)
    sl = spec.input_slices
    t = x[:, sl["state_t"]]
    rh = x[:, sl["state_rh"]]
    ps = x[:, sl["state_ps"].start]
    pmid = physics.midlevel_pressure(ps, grid.hyam, grid.hybm)
    qvs = (physics.RD * physics.saturation_pressure(t)) / (physics.RV * pmid)
    return rh * qvs


def newtonian_relaxation(clim_t, clim_q1, clim_u, tau_steps: float,
                         dt: float = physics.DT_TIMESTEP, lat=None,
                         diurnal_amp_k_per_day: float = 0.0,
                         steps_per_day: int = 72, device="cuda"):
    """Prescribed host-dynamics forcing: Newtonian relaxation toward a
    climatology, optionally with a latitude-modulated diurnal cycle.

    The hybrid loop's host model (E3SM dynamics + the non-superparameterized
    physics) continually forces the columns back toward a bounded climate;
    without it the emulated-tendency system has no attractor and any rollout
    -- reference MMF or hybrid alike -- drifts without bound.  This factory
    supplies that role for driver-level coupled testing: T, q1 and u relax
    toward ``clim_*`` (numpy or tensors, (n, 60), put on ``device``) with an
    e-folding time of ``tau_steps`` model steps, plus an optional solar
    diurnal cycle in the T forcing (amplitude in K/day at the equator,
    scaled by cos(lat) of the n columns).

    Returns forcing(state, step) -> (rows, 3, 60) in the state's dtype;
    ``step`` is the absolute step index (an int: the phase is computed on
    the host, so the forcing never waits on the card).  A state of E * n
    rows (ensemble members stacked on the batch axis) relaxes each member
    toward the same climatology, as the JAX package's vmap does.

    Applied identically to every run (reference ensemble members and the
    hybrid candidate), exactly as the real host dynamics is shared by the
    MMF and hybrid E3SM runs in the reference's online evaluation
    (online_testing/evaluation/monthly-online-rmse-visualization.ipynb).
    """
    rate = 1.0 / (float(tau_steps) * dt)  # per-second relaxation rate
    ct = torch.as_tensor(clim_t, device=device)
    cq = torch.as_tensor(clim_q1, device=device)
    cu = torch.as_tensor(clim_u, device=device)
    n = ct.shape[0]
    if lat is not None and diurnal_amp_k_per_day > 0.0:
        prof = torch.as_tensor(
            (diurnal_amp_k_per_day / 86400.0)
            * np.cos(np.deg2rad(np.asarray(lat, np.float64)))[:, None],
            dtype=ct.dtype, device=device)
    else:
        prof = None

    def forcing(state: ColumnState, step):
        rows, lev = state.t.shape
        if rows % n:
            raise ValueError(f"a state of {rows} columns; the forcing's "
                             f"climatology has {n} a member")
        grp = lambda a: a.reshape(-1, n, lev)
        ft = (ct - grp(state.t)) * rate
        if prof is not None:
            ft = ft + prof * math.sin(2.0 * math.pi * step / steps_per_day)
        fq = (cq - grp(state.q1)) * rate
        fu = (cu - grp(state.u)) * rate
        return torch.stack([ft, fq, fu], dim=2).reshape(rows, 3, lev).to(
            state.dyn.dtype)

    return forcing


@dataclass(frozen=True)
class _Consts:
    """The grid's coefficients and the fixed trace-gas profiles, cast once
    to a state's dtype and device."""

    hyam: torch.Tensor
    hybm: torch.Tensor
    hyai: torch.Tensor
    hybi: torch.Tensor
    gases: torch.Tensor   # (3, 60)


class HybridDriver:
    """Rollout engine around a wrapper fn(x_v4_raw) -> (B, 368).

    The port's wrappers close over their model, so ``step``, ``rollout``
    and ``rollout_ensemble`` take no ``params`` argument, where the JAX
    package's take one first."""

    def __init__(self, wrapper: Callable, grid: Grid,
                 dyn_forcing: Callable | None = None,
                 dt: float = physics.DT_TIMESTEP, remat: bool = False):
        """``remat=True`` runs each rollout step (assemble -> wrapper ->
        advance -> the trajectory's entries) under
        ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, the
        counterpart of ``jax.checkpoint(body)``
        (``climsim_tpu/online/driver.py:269-270``): a differentiated
        rollout (train/rollout_ft.py) keeps each step's inputs only and
        recomputes its activations in the backward, one step's memory
        instead of K steps' (a K = 16 fine-tune of the full U-Net v5 at
        384 columns otherwise outgrows an 80 GB card).  It costs one more
        forward a step, and only where gradients are taken: with no
        gradient wanted the step runs as it is."""
        self.wrapper = wrapper
        self.grid = grid
        self.dt = dt
        self.remat = remat
        self.dyn_forcing = dyn_forcing or (lambda state, step: (
            torch.zeros_like(state.dyn)))
        spec = get_varspec("v4")
        self._sl = spec.output_slices  # 368-contract slices (v2 layout)
        self._spec = spec
        self._consts_by = {}

    def _consts(self, like: torch.Tensor) -> _Consts:
        key = (like.dtype, like.device)
        if key not in self._consts_by:
            sigma = (np.arange(60) + 0.5) / 60.0
            # trace-gas profiles held fixed at climatology (zero anomaly
            # drive), made in float64 and rounded once, as the JAX
            # package's float64 features are when its wrapper casts them
            gases = np.stack([1e-6 * (1.2 - sigma) ** 2, np.full(60, 1e-6),
                              np.full(60, 1e-6)])
            g = self.grid
            self._consts_by[key] = _Consts(*(
                torch.as_tensor(np.asarray(a), dtype=like.dtype,
                                device=like.device)
                for a in (g.hyam, g.hybm, g.hyai, g.hybi, gases)))
        return self._consts_by[key]

    # -- feature assembly --------------------------------------------------
    def _pmid(self, ps):
        """Real hybrid-sigma mid-level pressure from the grid coefficients
        (data_utils.py:1049-1052)."""
        c = self._consts(ps)
        return physics.midlevel_pressure(ps, c.hyam, c.hybm)

    def _gases(self, s: ColumnState) -> list[torch.Tensor]:
        g = self._consts(s.t).gases.expand(s.t.shape[0], 3, 60)
        return [g[:, 0], g[:, 1], g[:, 2]]

    def assemble_v4(self, s: ColumnState) -> torch.Tensor:
        ps = s.scalars[:, 0]  # state_ps is the first scalar in the v4 tail
        rh = physics.relative_humidity(s.t, s.q1, self._pmid(ps))
        profs = [s.t, rh, s.qc, s.qi, s.u, s.v,
                 s.dyn[:, 0], s.dyn[:, 1], s.dyn[:, 2],
                 s.tm_dyn[:, 0], s.tm_dyn[:, 1], s.tm_dyn[:, 2],
                 s.prvphy[:, 0], s.prvphy[:, 1], s.prvphy[:, 2],
                 s.prvphy[:, 3], s.prvphy[:, 4],
                 s.tm_prvphy[:, 0], s.tm_prvphy[:, 1], s.tm_prvphy[:, 2],
                 s.tm_prvphy[:, 3], s.tm_prvphy[:, 4]]
        return torch.cat(profs + self._gases(s) + [s.scalars], dim=1)

    # -- one hybrid step ---------------------------------------------------
    def step(self, s: ColumnState, step_idx) -> tuple:
        return self._advance(s, self.assemble_v4(s), step_idx)

    def _advance(self, s: ColumnState, x, step_idx) -> tuple:
        tend = self.wrapper(x)  # (B, 368) raw
        sl = self._sl
        dt_t = tend[:, sl["ptend_t"]]
        dt_q1 = tend[:, sl["ptend_q0001"]]
        dt_qc = tend[:, sl["ptend_q0002"]]
        dt_qi = tend[:, sl["ptend_q0003"]]
        dt_u = tend[:, sl["ptend_u"]]
        dt_v = tend[:, sl["ptend_v"]]

        new_dyn = self.dyn_forcing(s, step_idx)
        # jnp.maximum(., 0), with its tie gradient: 0.5 where a species
        # stays at exactly 0 (a cloud-free stratospheric level every step),
        # where torch.clamp would pass all of it
        new = ColumnState(
            t=s.t + (dt_t + new_dyn[:, 0]) * self.dt,
            q1=physics.maximum(s.q1 + (dt_q1 + new_dyn[:, 1]) * self.dt, 0.0),
            qc=physics.maximum(s.qc + dt_qc * self.dt, 0.0),
            qi=physics.maximum(s.qi + dt_qi * self.dt, 0.0),
            u=s.u + (dt_u + new_dyn[:, 2]) * self.dt,
            v=s.v + dt_v * self.dt,
            scalars=s.scalars,
            prvphy=torch.stack([dt_t, dt_q1, dt_qc, dt_qi, dt_u], dim=1),
            tm_prvphy=s.prvphy,
            dyn=new_dyn,
            tm_dyn=s.dyn,
        )
        return new, tend

    def rollout(self, state0: ColumnState, n_steps: int,
                collect_features: bool = False, start_step: int = 0):
        """Step ``n_steps`` times; returns (final_state, trajectory dict),
        each trajectory value stacked on a leading step axis, on the
        state's device.

        ``start_step`` offsets the step index seen by the host-dynamics
        forcing.  Segmented long rollouts MUST pass the running offset:
        the diurnal cycle is a function of absolute step, and restarting
        each segment at 0 would jump the solar phase at every segment
        boundary.

        The trajectory includes the per-step column water-budget residual
        (the water_conservation.ipynb check): a coupling-grade emulator
        should keep it bounded over the rollout; secular growth flags a
        physics-breaking model.

        ``collect_features=True`` additionally records the assembled raw
        v4 feature vector at every step under key ``"x4"`` -- the
        on-manifold sampling path used to build coupling training sets
        from reference rollouts (scripts/online_eval.py).  Costs
        n_steps x B x 1525 values of device memory; segment long
        collections.
        """
        if n_steps < 1:
            raise ValueError(f"n_steps={n_steps}: want at least 1")
        start = int(start_step)
        body = self._body
        if self.remat and torch.is_grad_enabled():
            body = lambda *a: checkpoint(self._body, *a,  # noqa: E731
                                         use_reentrant=False)
        traj: dict = {}
        s = state0
        for i in range(n_steps):
            s, out = body(s, start + i, collect_features)
            for k, val in out.items():
                traj.setdefault(k, []).append(val)
        return s, {k: torch.stack(v) for k, v in traj.items()}

    def _body(self, s: ColumnState, step_idx: int,
              collect_features: bool) -> tuple:
        """One rollout step: (the next state, the step's trajectory
        entries)."""
        sl = self._sl
        c = self._consts(s.t)
        x = self.assemble_v4(s)
        new, tend = self._advance(s, x, step_idx)
        ps = s.scalars[:, 0]
        lhflx = s.scalars[:, 2]  # ps, SOLIN, LHFLX, ... scalar order
        precc = tend[:, sl["cam_out_PRECC"].start]
        wres = physics.column_water_residual(
            (tend[:, sl["ptend_q0001"]], tend[:, sl["ptend_q0002"]],
             tend[:, sl["ptend_q0003"]]),
            ps, c.hyai, c.hybi, precc,
            tend[:, sl["cam_out_PRECSC"].start], lhflx)
        out = {"t": new.t, "q1": new.q1, "qn": new.qc + new.qi, "u": new.u,
               "precc": precc, "water_res": wres}
        if collect_features:
            out["x4"] = x
        return new, out

    def rollout_ensemble(self, states0: ColumnState, n_steps: int,
                         start_step: int = 0):
        """All ensemble members in one rollout.

        ``states0``: a ColumnState whose fields carry a leading member
        axis (``stack_states`` over per-member states).  The members are
        stacked on the batch axis, so each step is one wrapper call of
        E * B rows (the reference's online evaluation compares against a
        3-member perturbed-IC MMF ensemble, online_testing/evaluation/
        *.ipynb), and the result is split back to a leading member axis:
        the final state (E, B, ...) and the trajectory (E, n_steps, B,
        ...), the JAX package's vmap layout.  Every wrapper is
        row-independent, so this is the per-member loop, up to the
        rounding of plain library calls that pick another algorithm at
        another batch.

        Memory: all members' trajectories live on the device at once
        (E x steps x ncol x ~242 values) -- for year-scale windows use
        the per-member ``rollout`` loop.
        """
        e, b = states0.t.shape[:2]
        flat = map_state(lambda a: a.reshape(e * b, *a.shape[2:]), states0)
        final, traj = self.rollout(flat, n_steps, start_step=start_step)
        final = map_state(lambda a: a.reshape(e, b, *a.shape[1:]), final)
        return final, {k: v.reshape(v.shape[0], e, b, *v.shape[2:])
                       .transpose(0, 1) for k, v in traj.items()}


class V2RHDriver(HybridDriver):
    """Rollout variant for v2_rh-family models (MLP_v2rh): the wrapper
    takes the 557-feature v2_rh layout (t, rh, qc, qi, u, v, gases, ps +
    surface scalars -- varspec.py V2_RH_INPUTS) instead of v4."""

    def assemble_v4(self, s: ColumnState) -> torch.Tensor:  # name: hook
        ps = s.scalars[:, 0]
        rh = physics.relative_humidity(s.t, s.q1, self._pmid(ps))
        profs = [s.t, rh, s.qc, s.qi, s.u, s.v]
        # the first 17 v4 scalars (ps, 6 pbuf fluxes, 10 cam_in) are
        # exactly the v2_rh scalar block in order
        return torch.cat(profs + self._gases(s) + [s.scalars[:, :17]],
                         dim=1)

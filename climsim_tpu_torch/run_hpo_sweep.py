"""A concurrent HPO sweep: N worker PROCESSES, one oracle directory (the
counterpart of ``scripts/run_hpo_sweep.py``).

The reference coordinates 1000 KerasTuner trials through a chief/worker
oracle over TCP across SLURM jobs (hpo_baseline_v1.py:17-43,224-245);
``train.hpo``'s directory oracle claims trials by exclusive file
creation instead.  This entry drives it at sweep scale:

  1. publishes --trials random-search trials (the reference's MLP space,
     depth and width cut so a trial takes seconds),
  2. starts a victim worker, waits until it holds a claim, then starts
     the other --workers - 1; all claim and run trials against the one
     directory,
  3. SIGKILLs the victim while it holds its claim; the survivors take
     the orphan over through the stale-claim path (claim_N.retryK),
  4. runs a Hyperband bracket on the same trial function,
  5. retrains the winner at four times the budget (retrain_best),
  6. writes the report (--out, default <work dir>/HPO.md).

Each trial is the port's ``recipes.mlp_trainer`` on the device given by
--device: the card by default, every worker on the one card; ``--device
cpu`` runs it on the host.  Kernel 1's launch counter lives in each
process, so every worker records in each result how many times it
launched kernel 1 for that trial, and the report sums them.

Usage:  python -m climsim_tpu_torch.run_hpo_sweep [--trials 50]
            [--workers 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

WORKER_DEADLINE_S = 600.0


def sweep_space():
    """The reference MLP space's axes (hpo_baseline_v1.py:66-77), depth
    and width cut (``scripts/run_hpo_sweep.py:43-54``)."""
    from .train.hpo import Choice, IntRange, SearchSpace

    return SearchSpace({
        "num_layers": IntRange(1, 3),
        "units": IntRange(32, 128, 32),
        "activation": Choice(("relu", "elu", "leakyrelu")),
        "batch_size": Choice((128, 256, 512)),
        "optimizer": Choice(("adam", "radam", "rmsprop")),
    })


def sample_trial(rng):
    from .train.hpo import sample_mlp_trial

    return sample_mlp_trial(sweep_space(), rng)


def make_trial_fn(data_path: str, steps: int, device="cuda"):
    """(hp, resource=None) -> validation loss.  Loads the shared synthetic
    split once, onto ``device``; each trial builds an MLP from seed 0,
    takes ``steps`` (times ``resource``) Adam steps on batches drawn with
    numpy's ``default_rng(1)``, and scores the first 2048 held-out rows
    (``scripts/run_hpo_sweep.py:62-92``)."""
    import numpy as np
    import torch

    from .norms import compute_norms_from_data
    from .train import recipes
    from .varspec import get_varspec

    spec = get_varspec("v1")
    blob = np.load(data_path)
    x, y = blob["x"], blob["y"]
    n_val = x.shape[0] // 8
    x_tr, y_tr = x[:-n_val], y[:-n_val]
    stats = compute_norms_from_data(spec, x_tr, y_tr)
    xd, yd = (torch.as_tensor(a, device=device) for a in (x_tr, y_tr))
    xv, yv = (torch.as_tensor(a[-n_val:][:2048], device=device)
              for a in (x, y))

    def trial_fn(hp, resource: int | None = None) -> float:
        n_steps = steps if resource is None else int(steps * resource)
        bs = int(hp["batch_size"])
        tr = recipes.mlp_trainer(
            spec, stats, (x_tr[:bs], y_tr[:bs]), 0,
            hidden=tuple(hp["hidden"]), activation=hp["activation"],
            optimizer_name=hp["optimizer"], steps_per_epoch=max(n_steps, 1),
            device=device)
        state = tr.state
        rng = np.random.default_rng(1)
        for _ in range(n_steps):
            idx = torch.as_tensor(rng.integers(0, x_tr.shape[0], bs),
                                  device=device)
            state, _m = tr.train_step(state, xd[idx], yd[idx])
        return float(tr.eval_step(state.params, xv, yv)["loss"])

    return trial_fn


def worker_main(args) -> None:
    """The claim-and-run loop of one worker process (``hpo.run_worker``'s,
    making passes until every trial has a result: an orphan becomes
    claimable only once its marker is stale).  The victim stalls on its
    first claim until it is killed."""
    from .ops import kernels as K
    from .train.hpo import DirectoryOracle

    oracle = DirectoryOracle(args.worker_dir)
    # the device and its kernels are ready before the first claim, so a
    # claim's age measures its trial alone
    trial_fn = make_trial_fn(args.data, args.steps, args.device)
    if args.device != "cpu":
        from .ops import _build

        _build.load()
    done = 0
    deadline = time.time() + WORKER_DEADLINE_S
    while time.time() < deadline:
        all_trials = oracle.trials()
        for idx in all_trials:
            if not oracle.claim(idx, stale_timeout=args.stale_timeout,
                                max_retries=1):
                continue
            if idx in oracle.results():
                continue
            if args.victim:
                time.sleep(WORKER_DEADLINE_S)   # holds the claim
            hp = oracle.load_trial(idx)
            t0 = time.time()
            before = K.LAUNCHES["fused_input_transform"]
            score = trial_fn(hp)
            oracle.report(idx, score, worker=args.worker_id,
                          seconds=round(time.time() - t0, 2),
                          kernel1_launches=(
                              K.LAUNCHES["fused_input_transform"] - before))
            done += 1
        if len(oracle.results()) >= len(all_trials):
            break
        time.sleep(min(2.0, args.stale_timeout / 2))
    print(f"worker {args.worker_id}: {done} trials", flush=True)


def _wait_for_claim(oracle_dir: str, proc, timeout: float) -> None:
    """Until the only worker started so far holds a claim."""
    t_end = time.time() + timeout
    while not any(f.startswith("claim_") for f in os.listdir(oracle_dir)):
        if proc.poll() is not None:
            out, _ = proc.communicate()
            raise RuntimeError(f"the victim exited before claiming:\n"
                               f"{out[-2000:]}")
        if time.time() > t_end:
            raise RuntimeError("the victim never claimed a trial")
        time.sleep(0.1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--n-data", type=int, default=8192)
    # a claim older than this with no result is a dead worker's: it must
    # exceed the slowest live trial under full contention, or survivors
    # steal live claims (duplicated trials, spurious retry markers)
    ap.add_argument("--stale-timeout", type=float, default=60.0)
    ap.add_argument("--kill-after", type=float, default=20.0,
                    help="seconds after the victim's claim")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; every worker on it) or cpu")
    ap.add_argument("--dir", default=None, help="work directory")
    ap.add_argument("--out", default=None,
                    help="report path (default <work dir>/HPO.md)")
    # a worker process's own flags
    ap.add_argument("--worker-dir", default=None)
    ap.add_argument("--worker-id", type=int, default=-1)
    ap.add_argument("--data", default=None)
    ap.add_argument("--victim", action="store_true")
    args = ap.parse_args(argv)
    if args.worker_dir:
        return worker_main(args)
    if args.workers < 2:
        ap.error("--workers: a victim and at least one survivor")

    import numpy as np
    import torch

    from .data.synthetic import synthetic_split
    from .grid import load_default_grid
    from .ops import kernels as K
    from .train.hpo import DirectoryOracle, hyperband, retrain_best
    from .varspec import get_varspec

    t_all = time.time()
    device = torch.device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the host CPU")
    work = args.dir or tempfile.mkdtemp(prefix="hpo_sweep_")
    os.makedirs(work, exist_ok=True)
    out_path = args.out or os.path.join(work, "HPO.md")
    x, y = synthetic_split(get_varspec("v1"), n=args.n_data,
                           grid=load_default_grid(), seed=0, noise=0.02)
    data_path = os.path.join(work, "data.npz")
    np.savez(data_path, x=x, y=y)

    oracle = DirectoryOracle(os.path.join(work, "oracle"))
    rng = np.random.default_rng(42)
    oracle.publish([sample_trial(rng) for _ in range(args.trials)])
    print(f"published {args.trials} trials in {oracle.dir}", flush=True)

    def spawn(wid, victim=False):
        cmd = [sys.executable, "-m", __spec__.name,
               "--worker-dir", oracle.dir, "--worker-id", str(wid),
               "--data", data_path, "--steps", str(args.steps),
               "--stale-timeout", str(args.stale_timeout),
               "--device", args.device]
        if victim:
            cmd += ["--victim"]
        return subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    t0 = time.time()
    victim = spawn(0, victim=True)
    workers = []
    try:
        _wait_for_claim(oracle.dir, victim, WORKER_DEADLINE_S)
        claim_t = time.time() - t0
        workers = [spawn(i) for i in range(1, args.workers)]
        time.sleep(args.kill_after)
        victim.send_signal(signal.SIGKILL)
        victim.wait()
        kill_t = time.time() - t0
        print(f"victim claimed at t={claim_t:.1f} s, killed at "
              f"t={kill_t:.1f} s", flush=True)
        for p in workers:
            out, _ = p.communicate(timeout=2 * WORKER_DEADLINE_S)
            print(out.strip()[-300:], flush=True)
            if p.returncode != 0:
                raise RuntimeError(f"a worker failed:\n{out[-3000:]}")
    finally:
        for p in [victim, *workers]:
            if p.poll() is None:
                p.kill()
                p.wait()
    sweep_seconds = time.time() - t0

    res = oracle.results()
    if len(res) != args.trials:
        raise RuntimeError(f"{len(res)}/{args.trials} trials completed")
    takeovers = sorted(
        int(m.group(1)) for f in os.listdir(oracle.dir)
        if (m := re.match(r"claim_(\d+)\.retry\d+$", f)))
    if not takeovers:
        raise RuntimeError("no stale-claim takeover happened")
    missing = [i for i in takeovers if i not in res]
    if missing:
        raise RuntimeError(f"taken-over trials {missing} have no result")
    best_idx, best = oracle.best()
    per_worker: dict = {}
    for r in res.values():
        per_worker[r.get("worker", "?")] = \
            per_worker.get(r.get("worker", "?"), 0) + 1
    worker_launches = sum(r["kernel1_launches"] for r in res.values())

    # the bracket is sequential by construction: this process runs it
    own0 = K.LAUNCHES["fused_input_transform"]
    t1 = time.time()
    trial_fn = make_trial_fn(data_path, max(args.steps // 4, 10),
                             args.device)
    hb_hp, hb_score = hyperband(
        lambda hp, r: trial_fn(hp, resource=r), sample_trial,
        directory=os.path.join(work, "hyperband"),
        max_resource=9, eta=3, seed=7)
    hb_seconds = time.time() - t1

    t2 = time.time()
    long_fn = make_trial_fn(data_path, args.steps * 4, args.device)
    hp_best, final_score = retrain_best(oracle, lambda hp: long_fn(hp))
    retrain_seconds = time.time() - t2
    own_launches = K.LAUNCHES["fused_input_transform"] - own0
    if not (np.isfinite(hb_score) and np.isfinite(final_score)):
        raise RuntimeError(f"Hyperband {hb_score}, retrain {final_score}")

    top = sorted(res.items(), key=lambda kv: kv[1]["score"])[:10]
    total = time.time() - t_all
    lines = [
        "# HPO sweep: concurrent workers, one directory oracle",
        "",
        f"`python -m climsim_tpu_torch.run_hpo_sweep --trials {args.trials}"
        f" --workers {args.workers} --steps {args.steps} --device "
        f"{args.device}` on {where}: {args.workers} worker processes "
        "sharing one oracle directory (`climsim_tpu_torch/train/hpo.py`), "
        "one of them SIGKILLed while it held a claim.",
        "",
        f"- {args.trials} random-search trials (the reduced NeurIPS MLP "
        f"space), {args.steps} steps each, {args.n_data} synthetic v1 "
        "samples",
        f"- sweep wall-clock: {sweep_seconds:.1f} s",
        f"- the victim claimed at t={claim_t:.1f} s and was killed at "
        f"t={kill_t:.1f} s; the survivors took trial(s) {takeovers} over "
        "(claim_N.retryK) and completed them",
        "- trials per worker: " + ", ".join(
            f"w{k}: {v}" for k, v in sorted(per_worker.items())),
        f"- kernel 1 launches: {worker_launches} in the workers' trials, "
        f"{own_launches} in the bracket and the retrain",
        "",
        "## Top 10 trials",
        "",
        "| rank | trial | val MSE | hidden | act | opt | batch | worker |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for rank, (idx, r) in enumerate(top, 1):
        hp = oracle.load_trial(idx)
        lines.append(
            f"| {rank} | {idx} | {r['score']:.5f} | {tuple(hp['hidden'])} "
            f"| {hp['activation']} | {hp['optimizer']} | "
            f"{hp['batch_size']} | w{r.get('worker', '?')} |")
    lines += [
        "",
        "## Hyperband",
        "",
        f"max_resource 9, eta 3: best {hb_score:.5f} with hidden="
        f"{tuple(hb_hp['hidden'])}, {hb_hp['activation']}, "
        f"{hb_hp['optimizer']}, batch {hb_hp['batch_size']} "
        f"({hb_seconds:.1f} s).",
        "",
        "## retrain_best",
        "",
        f"Trial {best_idx} (search score {best['score']:.5f}) retrained at "
        f"4x the steps: val MSE {final_score:.5f} "
        f"({retrain_seconds:.1f} s).",
        "",
        f"Total wall-clock: {total:.1f} s.",
    ]
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out_path}; total {total:.1f} s", flush=True)
    return {"results": res, "best": best, "hyperband_score": hb_score,
            "final_score": final_score, "takeovers": takeovers,
            "kernel1_launches": worker_launches + own_launches,
            "seconds": {"sweep": sweep_seconds, "hyperband": hb_seconds,
                        "retrain": retrain_seconds, "total": total},
            "report": out_path}


if __name__ == "__main__":
    main()

"""Hyperparameter optimization: random search + Hyperband with a
shared-filesystem trial oracle.

Replaces the reference's three HPO mechanisms:
  * KerasTuner RandomSearch with a chief/worker oracle over TCP
    (hpo_baseline_v1.py:17-43,227-245: SLURM jobs coordinate through
    KERASTUNER_TUNER_ID/ORACLE_IP env) -> a lock-free directory oracle:
    workers claim trials by exclusive file creation, so any number of
    hosts/processes sharing a filesystem cooperate with no server.
  * the torch random-search harness (HSR/training/tools.py:86-153)
  * Hyperband for the CNN (hpo_bair.py:358-368) -> successive halving on
    the same oracle.

Resumability mirrors the reference (overwrite=False semantics,
hpo_baseline_v1.py:232-235): finished trials persist as json and are never
re-run.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


# --------------------------------------------------------------------------
# search space
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Choice:
    options: tuple

    def sample(self, rng):
        return self.options[rng.integers(len(self.options))]


@dataclass(frozen=True)
class IntRange:
    lo: int
    hi: int
    step: int = 1

    def sample(self, rng):
        n = (self.hi - self.lo) // self.step + 1
        return int(self.lo + self.step * rng.integers(n))


@dataclass(frozen=True)
class LogRange:
    lo: float
    hi: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.lo), np.log(self.hi))))


@dataclass(frozen=True)
class SearchSpace:
    params: dict[str, Any]

    def sample(self, rng) -> dict:
        out = {}
        for k, v in self.params.items():
            out[k] = v.sample(rng) if hasattr(v, "sample") else v
        return out


def mlp_search_space() -> SearchSpace:
    """The NeurIPS MLP HPO space (hpo_baseline_v1.py:66-77): 2-12 layers of
    128..1024 units, activation, batch size, optimizer."""
    return SearchSpace({
        "num_layers": IntRange(2, 12),
        "units": IntRange(128, 1024, 128),   # sampled once per layer below
        "activation": Choice(("relu", "elu", "leakyrelu")),
        "batch_size": Choice((48, 96, 192, 384, 768, 1152, 1536, 2304,
                              3072)),
        "optimizer": Choice(("adam", "radam", "rmsprop", "sgd")),
    })


def sample_mlp_trial(space: SearchSpace, rng) -> dict:
    hp = space.sample(rng)
    layers = hp.pop("num_layers")
    units_spec = space.params["units"]
    hp["hidden"] = tuple(int(units_spec.sample(rng)) for _ in range(layers))
    hp.pop("units", None)
    return hp


# --------------------------------------------------------------------------
# directory oracle (multi-process / multi-host coordination)
# --------------------------------------------------------------------------
class DirectoryOracle:
    """Trial ledger on a shared filesystem.

    Layout: <dir>/trial_<i>.json (spec, written by the sweep generator),
    <dir>/claim_<i> (exclusive-create claim marker),
    <dir>/result_<i>.json (score + metadata).
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def publish(self, trials: list[dict]):
        for i, t in enumerate(trials):
            p = os.path.join(self.dir, f"trial_{i}.json")
            if not os.path.exists(p):
                tmp = p + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(t, f)
                os.replace(tmp, p)

    def trials(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("trial_") and name.endswith(".json"):
                out.append(int(name[len("trial_"):-len(".json")]))
        return sorted(out)

    def _try_create(self, path: str) -> bool:
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            return True
        except FileExistsError:
            return False

    def claim(self, idx: int, stale_timeout: float | None = None,
              max_retries: int = 1) -> bool:
        """Claim trial idx by exclusive file creation.

        With ``stale_timeout`` set, a claim whose marker is older than the
        timeout and has no result is treated as a crashed worker: takeover
        happens through exclusive creation of a retry-generation marker
        (claim_<i>.retry<k>), bounded by ``max_retries`` -- the reference's
        KerasTuner ``max_retries_per_trial=1`` semantics
        (hpo_baseline_v1.py:232-235), but crash-safe with no server.
        """
        base = os.path.join(self.dir, f"claim_{idx}")
        if self._try_create(base):
            return True
        if stale_timeout is None:
            return False
        if os.path.exists(os.path.join(self.dir, f"result_{idx}.json")):
            return False
        k, latest = 1, base
        while os.path.exists(base + f".retry{k}"):
            latest = base + f".retry{k}"
            k += 1
        if k - 1 >= max_retries:
            return False  # retry budget exhausted; leave the orphan
        try:
            age = time.time() - os.path.getmtime(latest)
        except OSError:
            return False
        if age < stale_timeout:
            return False
        return self._try_create(base + f".retry{k}")

    def load_trial(self, idx: int) -> dict:
        with open(os.path.join(self.dir, f"trial_{idx}.json")) as f:
            return json.load(f)

    def report(self, idx: int, score: float, **meta):
        p = os.path.join(self.dir, f"result_{idx}.json")
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"score": float(score), "time": time.time(), **meta},
                      f)
        os.replace(tmp, p)

    def results(self) -> dict[int, dict]:
        out = {}
        for name in os.listdir(self.dir):
            if name.startswith("result_") and name.endswith(".json"):
                idx = int(name[len("result_"):-len(".json")])
                with open(os.path.join(self.dir, name)) as f:
                    out[idx] = json.load(f)
        return out

    def best(self, mode: str = "min"):
        res = self.results()
        if not res:
            return None, None
        key = min if mode == "min" else max
        idx = key(res, key=lambda i: res[i]["score"])
        return idx, {**self.load_trial(idx), **res[idx]}


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------
def run_worker(oracle: DirectoryOracle,
               trial_fn: Callable[[dict], float],
               max_trials: int | None = None,
               stale_timeout: float | None = None,
               max_retries: int = 1) -> int:
    """Claim-and-run loop; safe to run in many processes concurrently.
    trial_fn(hp) -> score (lower is better).  Returns #trials this worker
    completed.

    With ``stale_timeout`` (seconds) the worker also takes over trials whose
    claim marker went stale with no result (crashed worker), at most
    ``max_retries`` times per trial.
    """
    done = 0
    for idx in oracle.trials():
        if max_trials is not None and done >= max_trials:
            break
        if not oracle.claim(idx, stale_timeout, max_retries):
            continue
        if idx in oracle.results():
            continue
        hp = oracle.load_trial(idx)
        score = trial_fn(hp)
        oracle.report(idx, score)
        done += 1
    return done


def random_search(trial_fn: Callable[[dict], float], space_sampler,
                  n_trials: int, directory: str, seed: int = 0,
                  mode: str = "min"):
    """Single-process convenience driver: publish + run + best."""
    rng = np.random.default_rng(seed)
    oracle = DirectoryOracle(directory)
    oracle.publish([space_sampler(rng) for _ in range(n_trials)])
    run_worker(oracle, trial_fn)
    return oracle.best(mode)


@dataclass
class HyperbandState:
    brackets: list = field(default_factory=list)


def hyperband(trial_fn: Callable[[dict, int], float], space_sampler,
              directory: str, max_resource: int = 27, eta: int = 3,
              seed: int = 0, mode: str = "min"):
    """Successive-halving Hyperband (CNN HPO, hpo_bair.py:358-368).

    trial_fn(hp, resource) -> score; resource is e.g. #epochs.
    """
    rng = np.random.default_rng(seed)
    s_max = int(np.log(max_resource) / np.log(eta))
    results = []
    for s in range(s_max, -1, -1):
        n = int(np.ceil((s_max + 1) / (s + 1) * eta**s))
        r = max_resource * eta ** (-s)
        configs = [space_sampler(rng) for _ in range(n)]
        scores = [np.inf] * n
        for i in range(s + 1):
            r_i = int(round(r * eta**i))
            scores = [trial_fn(hp, r_i) for hp in configs]
            order = np.argsort(scores)
            if mode == "max":
                order = order[::-1]
            keep = max(int(n * eta ** (-i - 1)), 1)
            configs = [configs[j] for j in order[:keep]]
            scores = [scores[j] for j in order[:keep]]
            n = len(configs)
        results.append((scores[0], configs[0]))
    best = min(results) if mode == "min" else max(results)
    return best[1], best[0]


def retrain_best(oracle: DirectoryOracle, build_and_train: Callable,
                 mode: str = "min"):
    """Step-2 retraining of the winning trial (the reference's
    step2_retrain.py flow: read the search results, rebuild the best
    architecture, train longer with best/last checkpoints + early stop --
    the caller's build_and_train(hp) encapsulates that loop)."""
    idx, best = oracle.best(mode)
    if idx is None:
        raise RuntimeError("no completed trials to retrain from")
    hp = oracle.load_trial(idx)
    return hp, build_and_train(hp)

"""One rank of the port's data-parallel CPU tests (tests/test_torch_
distributed.py): joins a gloo group through a FileStore (no TCP port, so
the tests are safe under xdist), runs one case and writes its results
with torch.save.  It imports torch and the port only, never jax.

    python tests/torch_dp_ranks.py CASE RANK WORLD STORE INPUT OUTPUT
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from climsim_tpu_torch.data.pipeline import BatchLoader  # noqa: E402
from climsim_tpu_torch.norms import identity_norms  # noqa: E402
from climsim_tpu_torch.parallel.mesh import (ShardingRules,  # noqa: E402
                                             make_mesh)
from climsim_tpu_torch.train import recipes  # noqa: E402
from climsim_tpu_torch.train.checkpoints import (  # noqa: E402
    DistributedCheckpointer)
from climsim_tpu_torch.train.step_shardmap import (  # noqa: E402
    make_shardmap_train_step)
from climsim_tpu_torch.varspec import get_varspec  # noqa: E402

SPEC = get_varspec("v1")


def data(n=256):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, SPEC.input_len)).astype(np.float32),
            rng.standard_normal((n, SPEC.output_len)).astype(np.float32))


def mlp_init():
    """mlp()'s weights as its recipe draws them from seed 0."""
    return mlp(None, None).model.state_dict()


def mlp(rules, weights):
    """mlp_trainer, float32 compute, hidden (32, 32), from ``weights``."""
    tr = recipes.mlp_trainer(SPEC, identity_norms(SPEC), None, 0,
                             rules=rules, hidden=(32, 32), steps_per_epoch=4,
                             compute_dtype=torch.float32, device="cpu")
    if weights is not None:
        tr.model.load_state_dict(weights)
    return tr


def hsr(rules, weights=None):
    tr = recipes.hsr_trainer(SPEC, identity_norms(SPEC), None, 3,
                             rules=rules, hidden=16, layers=1,
                             compute_dtype=torch.float32, device="cpu")
    if weights is not None:
        tr.model.load_state_dict(weights)
    return tr


def run_steps(tr, step, loader, n_stage1=None, stage2=None):
    """Losses of a pass over ``loader``; the first ``n_stage1`` steps
    through ``step``, the rest through ``stage2``."""
    state, losses = tr.state, []
    for i, (xb, yb) in enumerate(loader):
        fn = step if n_stage1 is None or i < n_stage1 else stage2
        state, m = fn(state, xb, yb)
        losses.append(float(m["loss"]))
    return losses


def params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def case_mlp(rules, inp):
    """4 steps of the DDP step and of the explicit all-reduce step."""
    x, y = data()
    out = {}
    for name in ("ddp", "explicit"):
        tr = mlp(rules, inp["weights"])
        step = (tr.train_step if name == "ddp" else make_shardmap_train_step(
            tr.loss_fn, tr.optimizer, rules))
        loader = BatchLoader(x, y, 64, rules, seed=7, device="cpu")
        out[name] = run_steps(tr, step, loader)
        out[name + "_params"] = params(tr.model)
    tr = mlp(rules, inp["weights"])
    ev = tr.eval_step(tr.model, *rules.shard_batch(x[:64], y[:64]))
    out["eval"] = float(ev["loss"])
    out["predict"] = tr.predict(tr.model, x[:70], 32)
    return out


def case_hsr(rules, inp):
    """HSR's MSE stage for 2 steps, then its NLL stage for 2."""
    x, y = data()
    tr = hsr(rules, inp["weights"])
    loader = BatchLoader(x, y, 64, rules, seed=7, device="cpu")
    losses = run_steps(tr, tr.train_step, loader, 2, tr.stage2_step)
    return {"losses": losses, "params": params(tr.model)}


def float32_mlp():
    """The mlp recipe at float32 compute, for run_experiment's presets:
    at bf16 the roundings of a product's row flip between batch splits
    (row results of a float32 GEMM depend on its M), and Adam's first
    updates carry a flip of a near-zero gradient to 1e-4 of the loss."""
    import functools

    recipes.mlp_trainer = functools.partial(recipes.mlp_trainer,
                                            compute_dtype=torch.float32)


def case_run(rules, inp):
    """run_experiment at train.num_data_shards=WORLD, then the trained
    state saved by DistributedCheckpointer from every rank."""
    from climsim_tpu_torch import run as PRUN
    from climsim_tpu_torch.config import ExperimentConfig

    float32_mlp()
    cfg = ExperimentConfig.from_dict(inp["config"]).override(
        f"train.num_data_shards={rules.world_size}",
        f'train.checkpoint_dir="{inp["ckpt"]}"')
    out = PRUN.run_experiment(cfg, verbose=False, device="cpu")
    ck = DistributedCheckpointer(inp["dcp"])
    ck.save(out["state"].step, out["state"])
    ck.wait()
    return {"history": [(r["train_loss"], r["val_loss"])
                        for r in out["history"].rows],
            "params": params(out["state"].params),
            "step": out["state"].step,
            "rng": out["state"].rng.get_state(),
            "opt": {k: {n: v.clone() for n, v in s.items()}
                    for k, s in enumerate(
                        out["state"].opt_state.state.values())}}


def main(case, rank, world, store, inp, out):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world)
    try:
        rules = ShardingRules(make_mesh(num_data=world, device="cpu"))
        result = globals()[f"case_{case}"](rules, torch.load(inp))
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    c, r, w, s, i, o = sys.argv[1:]
    main(c, int(r), int(w), s, i, o)

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


def mesh_rules(inp):
    """The (data, model) mesh ``inp["mesh"]`` over the ranks."""
    d, m = inp["mesh"]
    return ShardingRules(make_mesh(d, m, device="cpu"))


def rpn(rules, ensemble_size=4, seed=0):
    """rpn_trainer at float32 compute, hidden (16,), from ``seed``."""
    from climsim_tpu_torch.train.rpn_recipe import rpn_trainer

    return rpn_trainer(SPEC, identity_norms(SPEC), None, seed,
                       ensemble_size=ensemble_size, hidden=(16,),
                       compute_dtype=torch.float32, rules=rules,
                       device="cpu")


def case_mesh(rules, inp):
    """make_mesh over 4 ranks at (2, 2) and (1, 4), and over the prefix
    [0, 1] at (1, 2): each rank's coordinates, its groups' ranks, a mean
    over the data group and a gather over the model group."""
    out = {}
    for shape in ((2, 2), (1, 4)):
        r = ShardingRules(make_mesh(*shape, device="cpu"))
        me = float(dist.get_rank())
        out[shape] = {
            "coords": (r.rank, r.model_rank),
            "data": dist.get_process_group_ranks(r.mesh.data_group),
            "model": dist.get_process_group_ranks(r.mesh.model_group),
            "mean": float(r.mean([torch.tensor(me)])[0]),
            "gather": r.gather_model(torch.tensor([me, -me])).tolist()}
    m = make_mesh(1, 2, device="cpu", ranks=[0, 1])
    out["prefix"] = None if m is None else (
        m.data_index, m.model_index, dist.get_process_group_ranks(m.group))
    return out


def rpn_run(rules, steps=3, ensemble_size=4, weights=None):
    """3 RPN steps over BootstrapLoader (global batch 32): the (E,) step
    losses, eval_losses and posterior on 40 rows, and this rank's
    members' state (with its first member's global index).  ``weights``:
    the whole ensemble's state dict, this rank's members loaded."""
    from climsim_tpu_torch.data.pipeline import BootstrapLoader

    x, y = data()
    tr = rpn(rules, ensemble_size)
    if weights is not None:
        n = tr.ensemble.ensemble_size
        tr.ensemble.load_state_dict({k: v[tr.first:tr.first + n]
                                     for k, v in weights.items()})
    ld = BootstrapLoader(x, y, 32, ensemble_size, rules=rules, seed=5,
                         steps_per_epoch=steps, device="cpu")
    losses = torch.stack([tr.train_step(xb, yb) for xb, yb in ld])
    xv, yv = torch.from_numpy(x[:40]), torch.from_numpy(y[:40])
    return {"losses": losses, "eval": tr.eval_losses(xv, yv),
            "posterior": tr.posterior(xv), "first": tr.first,
            "params": params(tr.ensemble),
            "exp_avg": [s["exp_avg"].clone()
                        for s in tr.opt_state.state.values()]}


def case_rpn(rules, inp):
    """The RPN over the mesh ``inp["mesh"]``, from ``inp["weights"]``."""
    rules = mesh_rules(inp)
    out = rpn_run(rules, weights=inp.get("weights"))
    out["coords"] = (rules.rank, rules.model_rank)
    return out


def multiseed_run(rules, seeds=(0, 1), weights=None):
    """2 steps of a 2-seed mlp_trainer multiseed (float32, hidden (16,))
    over BatchLoader (global batch 64): the (K,) losses, predict and the
    replicas' parameters here.  ``weights``: each seed's state dict, this
    rank's replicas loaded."""
    from climsim_tpu_torch.data.pipeline import BatchLoader as BL
    from climsim_tpu_torch.train.multiseed import multiseed

    x, y = data()
    ms = multiseed(recipes.mlp_trainer, SPEC, identity_norms(SPEC), None,
                   list(seeds), rules=rules, hidden=(16,),
                   compute_dtype=torch.float32, steps_per_epoch=2,
                   device="cpu")
    if weights is not None:
        for j, p in enumerate(ms.state.params):
            p.load_state_dict(weights[ms.state.first + j])
    state, losses = ms.state, []
    for i, (xb, yb) in enumerate(BL(x, y, 64, rules, seed=3,
                                    device="cpu")):
        if i == 2:
            break
        state, m = ms.train_step(state, xb, yb)
        losses.append(m["loss"])
    return {"losses": torch.stack(losses), "first": state.first,
            "predict": ms.predict(state.params, x[:10]),
            "params": [params(p) for p in state.params]}


def case_multiseed(rules, inp):
    return multiseed_run(mesh_rules(inp), weights=inp.get("weights"))


def elastic_factories(weights=None, seeds=None, batch=64):
    """elastic_fit's factories: mlp_trainer (float32, hidden (32, 32),
    from ``weights``) or, with ``seeds``, its multiseed (hidden (16,),
    replica k from ``weights[k]``), over BatchLoader (seed 7)."""
    from climsim_tpu_torch.train.multiseed import multiseed

    x, y = data()

    def trainer_factory(rules):
        if seeds is None:
            return mlp(rules, weights)
        ms = multiseed(recipes.mlp_trainer, SPEC, identity_norms(SPEC),
                       None, list(seeds), rules=rules, hidden=(16,),
                       compute_dtype=torch.float32, steps_per_epoch=4,
                       device="cpu")
        for j, p in enumerate(ms.state.params):
            p.load_state_dict(weights[ms.state.first + j])
        return ms

    def loader_factory(rules):
        return BatchLoader(x, y, batch, rules, seed=7, device="cpu"), None

    return trainer_factory, loader_factory


def rpn_factories(ensemble_size=4):
    from climsim_tpu_torch.data.pipeline import BootstrapLoader

    x, y = data()
    return (lambda rules: rpn(rules, ensemble_size),
            lambda rules: BootstrapLoader(x, y, 32, ensemble_size,
                                          rules=rules, seed=5,
                                          steps_per_epoch=3, device="cpu"))


def state_result(state, report):
    """What a test reads of an elastic run's end: the report, and the
    parameters here (each replica's under its seed's index, or each
    member's stack with the first member's index)."""
    from dataclasses import asdict

    out = {"report": asdict(report)}
    if state is None:
        return out
    if hasattr(state, "states"):
        out["params"] = {state.first + j: params(p)
                         for j, p in enumerate(state.params)}
    elif hasattr(state, "ensemble"):
        out["params"], out["first"] = params(state.ensemble), state.first
    else:
        out["params"] = params(state.params)
    return out


def case_elastic(rules, inp):
    """elastic_fit (or elastic_rpn_fit, ``inp["rpn"]``) under the group
    for ``inp["epochs"]`` epochs, checkpointed in ``inp["dir"]``; every
    rank fails at ``inp["fail"]`` (epoch, step), and the result says so
    (elastic_fit commits the save in flight before it re-raises)."""
    from climsim_tpu_torch.train.elastic import (DeviceFailure,
                                                 elastic_fit,
                                                 elastic_rpn_fit)

    ck = DistributedCheckpointer(inp["dir"])

    def inject(epoch, step):
        if inp.get("fail") == (epoch, step):
            raise DeviceFailure("planted")

    try:
        if inp.get("rpn"):
            tr, rep = elastic_rpn_fit(*rpn_factories(), inp["epochs"], 4,
                                      device="cpu", checkpointer=ck,
                                      fault_injector=inject)
            return state_result(tr, rep)
        state, rep = elastic_fit(
            *elastic_factories(inp.get("weights"), inp.get("seeds")),
            inp["epochs"], device="cpu", num_model=inp.get("num_model", 1),
            checkpointer=ck, fault_injector=inject)
    except DeviceFailure:
        return {"failed": True}
    return state_result(state, rep)


def serve_wrappers():
    """The served functions of the sharded-server cases: the echo wrapper
    of tests/test_server.py and the MLP_v2rh fast wrapper on the CPU (its
    kernels' plain versions), hidden (64, 64) from seed 0; each with its
    input width, base chunk and largest bucket."""
    from climsim_tpu_torch import get_varspec, load_asset_norms
    from climsim_tpu_torch.models import OnlineMLP
    from climsim_tpu_torch.online.wrapper import make_fast_mlp_wrapper

    spec = get_varspec("v2_rh")
    torch.manual_seed(0)
    model = OnlineMLP(spec, hidden=(64, 64))
    mlp = make_fast_mlp_wrapper(model, load_asset_norms("v2_rh"), spec,
                                torch.bfloat16, device="cpu", max_batch=256)
    return {"echo": (lambda x: x[:, :8] * 2.0 + 1.0, 16, 50, 200),
            "mlp": (mlp, spec.input_len, 64, 256)}


def serve_requests(name, n_features):
    """The requests of a served path: 3 concurrent 64-row chunks, a
    ragged 50-row request, then 6 sequential 64-row ones."""
    from climsim_tpu_torch import get_varspec
    from climsim_tpu_torch.data.synthetic import synthetic_inputs
    from climsim_tpu_torch.grid import load_default_grid

    if name == "echo":
        rng = np.random.default_rng(4)
        make = (lambda n, s: rng.normal(size=(n, n_features)).astype(
            np.float32))
    else:
        spec, grid = get_varspec("v2_rh"), load_default_grid()
        make = (lambda n, s: synthetic_inputs(spec, n, grid, seed=s)
                .astype(np.float32))
    return ([make(64, 10 + i) for i in range(3)], make(50, 20),
            [make(64, 30 + i) for i in range(6)])


def drive_server(srv, chunks, ragged, sequential):
    """The replies to ``serve_requests``'s requests: the 3 chunks sent
    together while the dispatcher is held, so they coalesce into one
    call."""
    import threading
    import time

    from climsim_tpu_torch.online.server import CouplingClient

    srv.dispatch_paused.set()
    time.sleep(0.2)
    outs = [None] * len(chunks)

    def call(i):
        cl = CouplingClient("127.0.0.1", srv.port)
        outs[i] = cl.step(chunks[i])
        cl.close()

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(chunks))]
    for t in threads:
        t.start()
    while srv._q.qsize() < len(chunks):
        time.sleep(0.01)
    srv.dispatch_paused.clear()
    for t in threads:
        t.join(60)
    cl = CouplingClient("127.0.0.1", srv.port)
    outs.append(cl.step(ragged))
    outs += [cl.step(x) for x in sequential]
    cl.close()
    return outs


def case_serve(rules, inp):
    """A sharded CouplingServer on rank 0 of each served path, the other
    ranks following until its stop(): rank 0's replies, buckets and
    calls, the others' count of calls served."""
    from climsim_tpu_torch.online.server import (CouplingServer,
                                                 serve_follower)

    out = {}
    for name, (fn, nf, base, top) in serve_wrappers().items():
        if rules.rank:
            out[name] = {"calls": serve_follower(fn, nf, rules)}
            continue
        srv = CouplingServer(fn, nf, base_chunk=base, max_batch=top,
                             device="cpu", rules=rules).start()
        try:
            replies = drive_server(srv, *serve_requests(name, nf))
        finally:
            srv.stop()
        out[name] = {"replies": replies, "buckets": srv.buckets,
                     "calls": srv.stats.batches + len(srv.buckets)}
    return out


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

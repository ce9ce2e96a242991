"""A worker of tests/test_torch_elastic.py's agent-driven case, started by
``python -m torch.distributed.run``: joins the gloo group from the
agent's environment, trains through elastic_fit with a
DistributedCheckpointer, and, on the agent's first attempt, fails on
rank 1 in the middle of epoch 1.  Rank 0 writes its parameters and
report with torch.save.  It imports torch and the port only, never jax.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        --max-restarts 1 tests/torch_elastic_worker.py DIR FAIL WEIGHTS
"""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from climsim_tpu_torch.parallel.mesh import (  # noqa: E402
    distributed_init_if_needed)
from climsim_tpu_torch.train.checkpoints import (  # noqa: E402
    DistributedCheckpointer)
from climsim_tpu_torch.train.elastic import (  # noqa: E402
    DeviceFailure, elastic_fit)

import torch_dp_ranks as R  # noqa: E402

EPOCHS = 3


def main(directory: str, fail: bool, weights: str) -> None:
    torch.set_num_threads(1)
    distributed_init_if_needed("gloo")
    attempt = int(os.environ["TORCHELASTIC_RESTART_COUNT"])

    def inject(epoch, step):
        if fail and attempt == 0 and dist.get_rank() == 1 and \
                (epoch, step) == (1, 1):
            raise DeviceFailure("planted on the first attempt")

    try:
        state, report = elastic_fit(
            *R.elastic_factories(torch.load(weights)), EPOCHS, device="cpu",
            checkpointer=DistributedCheckpointer(os.path.join(directory,
                                                              "ck")),
            fault_injector=inject)
        if dist.get_rank() == 0:
            torch.save(R.state_result(state, report),
                       os.path.join(directory, "out.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] == "1", sys.argv[3])

"""The port's sharded coupling server (``CouplingServer(rules=...)`` and
``serve_follower``) over 2 gloo ranks on the CPU (tests/torch_dp_ranks.py
through a FileStore): the counterpart of
tests/test_server.py::test_mesh_sharded_serving.

Oracles: every reply equals the unsharded port server's, bit for bit
(the echo wrapper is elementwise; the MLP_v2rh fast wrapper's plain
versions act row by row), the buckets divide by the world size, and
rank 0's stop() ends the follower, which served every call.
"""

import numpy as np
import pytest
import torch

from climsim_tpu_torch.online.server import CouplingServer

import torch_dp_ranks as R
from test_torch_model_axis import spawn


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return spawn("serve", tmp_path_factory.mktemp("serve"), {}, 2)


@pytest.mark.parametrize("name", ["echo", "mlp"])
def test_sharded_replies_equal_the_unsharded_server(sharded, name):
    """3 coalesced 64-row chunks, a ragged 50-row request and 6 sequential
    ones, served over 2 ranks: the replies are the unsharded server's
    (and, for the echo, x[:, :8] * 2 + 1); base_chunk and max_batch were
    rounded up to multiples of the world size."""
    fn, nf, base, top = R.serve_wrappers()[name]
    got = sharded[0][name]
    assert all(b % 2 == 0 for b in got["buckets"])
    assert got["buckets"][0] >= base and got["buckets"][-1] >= top
    # one intra-op thread, as on the ranks: the CPU's float32 products
    # split their sums by thread count, not by rows
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    srv = CouplingServer(fn, nf, base_chunk=base, max_batch=top,
                         device="cpu").start()
    try:
        want = R.drive_server(srv, *R.serve_requests(name, nf))
    finally:
        srv.stop()
        torch.set_num_threads(threads)
    assert len(got["replies"]) == len(want) == 10
    for a, b in zip(got["replies"], want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if name == "echo":
        chunks, ragged, seq = R.serve_requests(name, nf)
        for x, y in zip(chunks + [ragged] + seq, got["replies"]):
            np.testing.assert_array_equal(y, x[:, :8] * 2.0 + 1.0)


def test_stop_ends_the_follower(sharded):
    """The follower returned when rank 0 stopped each server, having run
    every sharded call rank 0 made (the warm-up's buckets and the
    served ones); a rank other than 0 cannot host the server, and a
    model axis is refused."""
    for name in ("echo", "mlp"):
        assert sharded[1][name]["calls"] == sharded[0][name]["calls"] > 0
    from climsim_tpu_torch.parallel import mesh as PM

    rank1 = PM.ShardingRules(PM.Mesh(2, 1, torch.device("cpu"), None))
    with pytest.raises(ValueError, match="rank 0"):
        CouplingServer(lambda x: x, 4, rules=rank1, warmup=False,
                       device="cpu")
    model = PM.ShardingRules(PM.Mesh(2, 0, torch.device("cpu"), None, 2))
    with pytest.raises(ValueError, match="data axis only"):
        CouplingServer(lambda x: x, 4, rules=model, warmup=False,
                       device="cpu")

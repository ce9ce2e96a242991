"""The port's coupling TCP bridge (climsim_tpu_torch.online.server), mirroring
tests/test_server.py, and the serving slice as a whole: the JAX sidecar
serving the JAX fast wrapper against the port's sidecar serving the port's
fast wrapper, on the same columns and the same (ported) weights."""

import os
import subprocess
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.grid import load_default_grid
from climsim_tpu.models import OnlineMLP as FlaxOnlineMLP
from climsim_tpu.norms import load_asset_norms
from climsim_tpu.online import server as jax_server
from climsim_tpu.online.wrapper import \
    make_fast_mlp_wrapper as jax_fast_wrapper
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data.synthetic import synthetic_inputs
from climsim_tpu_torch.models import OnlineMLP, build_model
from climsim_tpu_torch.online.server import (MAGIC, CouplingClient,
                                             CouplingServer)
from climsim_tpu_torch.online.wrapper import (make_fast_mlp_wrapper,
                                              make_v2rh_wrapper)
from climsim_tpu_torch.utils.migrate import port_flax_online_mlp

SPEC = get_varspec("v2_rh")
STATS = load_asset_norms("v2_rh")


def _echo_wrapper(x):
    return x[:, :8] * 2.0 + 1.0


@pytest.fixture()
def echo_server():
    srv = CouplingServer(_echo_wrapper, n_features=16, base_chunk=64,
                         max_batch=256, warmup=True, device="cpu")
    srv.start()
    yield srv
    srv.stop()


def _call_concurrently(srv, xs):
    """Queue every request while the dispatcher is paused, then release it;
    return the replies."""
    srv.dispatch_paused.set()
    time.sleep(0.2)  # let the dispatcher's in-flight q.get time out
    outs = [None] * len(xs)

    def call(i):
        cl = CouplingClient("127.0.0.1", srv.port)
        outs[i] = cl.step(xs[i])
        cl.close()

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for _ in range(500):
        if srv._q.qsize() == len(xs):
            break
        time.sleep(0.01)
    assert srv._q.qsize() == len(xs)
    srv.dispatch_paused.clear()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return outs


def test_roundtrip_matches_direct(echo_server):
    cl = CouplingClient("127.0.0.1", echo_server.port)
    x = np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)
    y = cl.step(x)
    np.testing.assert_array_equal(y, _echo_wrapper(torch.from_numpy(x)))
    cl.close()
    assert echo_server.stats.requests == 1


def test_bucket_padding_never_leaks(echo_server):
    cl = CouplingClient("127.0.0.1", echo_server.port)
    x = np.random.default_rng(1).normal(size=(50, 16)).astype(np.float32)
    y = cl.step(x)  # 50 rows -> bucket 64, 14 padded rows dropped
    assert y.shape == (50, 8)
    np.testing.assert_array_equal(y, x[:, :8] * np.float32(2.0) + 1.0)
    cl.close()
    assert echo_server.stats.padded_rows >= 14


def test_concurrent_requests_coalesce(echo_server):
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(64, 16)).astype(np.float32) for _ in range(3)]
    before = echo_server.stats.batches
    outs = _call_concurrently(echo_server, xs)
    for x, y in zip(xs, outs):
        np.testing.assert_array_equal(y, x[:, :8] * np.float32(2.0) + 1.0)
    # 3 requests x 64 rows coalesced into ONE 192-row (bucket 256) batch
    assert echo_server.stats.batches == before + 1


def test_coalescing_never_exceeds_max_batch(echo_server):
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(100, 16)).astype(np.float32) for _ in range(3)]
    before = echo_server.stats.batches
    outs = _call_concurrently(echo_server, xs)
    for x, y in zip(xs, outs):
        np.testing.assert_array_equal(y, x[:, :8] * np.float32(2.0) + 1.0)
    # 300 rows > max_batch 256 -> two device calls (200 + 100), never one
    assert echo_server.stats.batches == before + 2


def test_model_error_sends_zero_row_frame():
    """A wrapper that raises answers with the 0-row error frame, the client
    raises, and the dispatcher keeps serving."""
    def boom(x):
        raise ValueError("model failure")

    srv = CouplingServer(boom, n_features=16, base_chunk=64, max_batch=64,
                         warmup=False, device="cpu").start()
    try:
        cl = CouplingClient("127.0.0.1", srv.port)
        x = np.ones((4, 16), np.float32)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="model-execution error"):
                cl.step(x)
        cl.close()
        assert srv.stats.batches == 0 and srv.stats.requests == 2
    finally:
        srv.stop()


def test_wire_format_matches_reference():
    assert MAGIC == jax_server.MAGIC == 0x434C4D54


def _tiny_v2rh_wrapper():
    model = build_model("mlp_online", SPEC, hidden=(32,),
                        generator=torch.Generator().manual_seed(0))
    return make_v2rh_wrapper(model, STATS, SPEC, device="cpu")


def test_real_v2rh_wrapper_served():
    wrap = _tiny_v2rh_wrapper()
    x = synthetic_inputs(SPEC, 64, load_default_grid(), seed=0)
    srv = CouplingServer(wrap, n_features=SPEC.input_len, base_chunk=64,
                         max_batch=128, warmup=False,
                         device="cpu").start()
    try:
        cl = CouplingClient("127.0.0.1", srv.port)
        y = cl.step(x)
        cl.close()
        assert y.shape == (64, SPEC.output_len)
        with torch.inference_mode():
            direct = wrap(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(y, direct)
    finally:
        srv.stop()


def test_c_client_roundtrip(tmp_path):
    """The compiled C host client (runtime/climclient.c) speaks the wire
    protocol to the port's sidecar: 20 physics steps over one connection."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    exe = os.path.join(root, "runtime", "climclient")
    if not os.path.exists(exe):
        pytest.skip("runtime/climclient not built (no C toolchain)")

    grid = load_default_grid()
    wrap = _tiny_v2rh_wrapper()
    x = synthetic_inputs(SPEC, grid.ncol, grid, seed=0)
    srv = CouplingServer(wrap, n_features=SPEC.input_len,
                         base_chunk=grid.ncol, max_batch=2 * grid.ncol,
                         warmup=True, device="cpu").start()
    try:
        fin, fout = tmp_path / "in.f32", tmp_path / "out.f32"
        fin.write_bytes(np.ascontiguousarray(x, "<f4").tobytes())
        res = subprocess.run(
            [exe, "127.0.0.1", str(srv.port), str(fin), str(x.shape[0]),
             str(x.shape[1]), str(fout), "20"],
            capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert "latency ms" in res.stdout
        y = np.frombuffer(fout.read_bytes(), "<f4").reshape(
            x.shape[0], SPEC.output_len)
        with torch.inference_mode():
            direct = wrap(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(y, direct)
    finally:
        srv.stop()


@pytest.mark.parametrize("wdtype", ["bf16", "int8"])
def test_slice_jax_server_vs_port_server(wdtype):
    """The serving slice end to end in both packages: raw columns over TCP
    -> input transform -> fused MLP -> un-scale -> reply.  Same columns,
    same weights (moved by the porter); replies agree at the fast
    wrapper's tolerance (rtol 2e-4, atol 1e-5; normalized units at rtol
    2e-4, atol 1e-4), see tests/test_torch_wrapper.py."""
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "int8": ("int8", "int8")}[wdtype]
    fl = FlaxOnlineMLP(spec=SPEC, hidden=(64, 64))
    params = fl.init(jax.random.PRNGKey(3),
                     jnp.zeros((1, SPEC.input_len), jnp.float32))
    model = OnlineMLP(SPEC, hidden=(64, 64))
    model.load_state_dict(port_flax_online_mlp(
        jax.tree.map(np.asarray, params["params"])))

    rng_cols = [synthetic_inputs(SPEC, n, load_default_grid(), seed=s)
                for s, n in ((0, 64), (1, 64), (2, 50))]
    jsrv = jax_server.CouplingServer(
        jax_fast_wrapper(fl, params, STATS, SPEC, weights_dtype=jdt), None,
        n_features=SPEC.input_len, base_chunk=64, max_batch=128,
        warmup=False).start()
    psrv = CouplingServer(
        make_fast_mlp_wrapper(model, STATS, SPEC, weights_dtype=tdt,
                              device="cpu"),
        n_features=SPEC.input_len, base_chunk=64, max_batch=128,
        warmup=True, device="cpu").start()
    try:
        jcl = jax_server.CouplingClient("127.0.0.1", jsrv.port)
        pcl = CouplingClient("127.0.0.1", psrv.port)
        scale = STATS.out_scale.astype(np.float32)
        for x in rng_cols:
            want, got = jcl.step(x), pcl.step(x)
            assert got.shape == want.shape == (x.shape[0], 368)
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
            np.testing.assert_allclose(got * scale, want * scale,
                                       rtol=2e-4, atol=1e-4)
        jcl.close()
        pcl.close()
    finally:
        jsrv.stop()
        psrv.stop()

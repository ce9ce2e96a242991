"""The port's deployment path: ``online.wrapper.export_aot`` / ``load_aot``,
``package_e3sm`` bundles and ``serve --bundle``, on the CPU at tiny
widths (the MLP_v2rh, unet_v4 and two-stage unet_v5 presets cut by
``--set``).

Every program is loaded back and held to the live wrapper within
1e-5 * max(1, max|want|), the JAX packager's verify tolerance
(scripts/package_e3sm.py:187-205); on the CPU both run the same plain
versions, and they come out bit-equal.  The programs reach the kernels
as operators of torch.library, which the graph must show.  The norm txt
files are the JAX package's, byte for byte."""

import json
import os

import numpy as np
import pytest
import torch

from climsim_tpu.norms import load_asset_norms as jax_norms
from climsim_tpu_torch import package_e3sm as P
from climsim_tpu_torch import serve
from climsim_tpu_torch.config import PRESETS
from climsim_tpu_torch.data.synthetic import synthetic_inputs
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.models import build_model
from climsim_tpu_torch.norms import NormStats, load_asset_norms
from climsim_tpu_torch.online import wrapper as PW
from climsim_tpu_torch.online.server import CouplingClient
from climsim_tpu_torch.ops import kernels as PK
from climsim_tpu_torch.train.checkpoints import TopKCheckpointer, save_state
from climsim_tpu_torch.varspec import get_varspec

TINY_UNET = ("model_kw.model_channels=16", "model_kw.channel_mult=[1, 2]",
             "model_kw.num_blocks=1", "model_kw.attn_resolutions=[32]")
TINY_MLP = ("model_kw.hidden=[32, 32]",)
BUNDLE_TOL = 1e-5   # scripts/package_e3sm.py:187-205
OPS = {"fused_input_transform", "fused_constraint_head",
       "fused_gn_silu_conv3"}
# the kernels' operators each bundle's program must call
WANT_OPS = {"mlp_v2rh": {"fused_input_transform"},
            "unet_v4": {"fused_input_transform", "fused_gn_silu_conv3"},
            "unet_v5": OPS}


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """preset -> (bundle dir, metadata): MLP_v2rh from a top-K directory
    through the CLI (buckets 8 and 16), unet_v4 fresh, and the two-stage
    unet_v5 from save_state files, each verified."""
    root = tmp_path_factory.mktemp("bundles")
    spec = get_varspec("v2_rh")
    cfg = PRESETS["mlp_v2rh"].override(*TINY_MLP)
    topk = TopKCheckpointer(str(root / "topk"), k=2)
    for step, metric in ((1, 0.5), (2, 0.3), (3, 0.4)):
        topk.maybe_save(metric, step, build_model(
            cfg.model, spec, **cfg.model_kw,
            generator=torch.Generator().manual_seed(step)))
    out = {}
    P.main(["--preset", "mlp_v2rh", "--ckpt", str(root / "topk"),
            "--buckets", "8,16", "--out", str(root / "mlp"), "--verify",
            "--device", "cpu", "--set", TINY_MLP[0]])
    with open(root / "mlp" / "metadata.json") as f:
        out["mlp_v2rh"] = (str(root / "mlp"), json.load(f))
    out["unet_v4"] = (str(root / "v4"), P.build_bundle(
        "unet_v4", None, str(root / "v4"), [8], verify=True,
        overrides=TINY_UNET, device="cpu"))
    spec5 = get_varspec("v5")
    for name, seed in (("unet_v5", 5), ("unet_v5_classifier", 6)):
        c = PRESETS[name].override(*TINY_UNET)
        m = build_model(c.model, spec5, **c.model_kw,
                        generator=torch.Generator().manual_seed(seed))
        save_state(str(root / f"{name}.pt"), m)
    out["unet_v5"] = (str(root / "v5"), P.build_bundle(
        "unet_v5", str(root / "unet_v5.pt"), str(root / "v5"), [8],
        cls_ckpt=str(root / "unet_v5_classifier.pt"), verify=True,
        overrides=TINY_UNET, cls_overrides=TINY_UNET, device="cpu"))
    return out


def _columns(meta, b, seed=3):
    spec = get_varspec(meta["input_version"])
    x = synthetic_inputs(spec, b, load_default_grid(), seed=seed)
    return torch.from_numpy(x)


@pytest.mark.parametrize("preset", sorted(WANT_OPS))
def test_bundle_round_trip(bundles, preset):
    """Each program: verified against the live wrapper when it was
    written, the kernels' operators in its graph, and loaded again on
    fresh columns equal to a second load (a program is a pure function
    of its input)."""
    d, meta = bundles[preset]
    for name, a in meta["artifacts"].items():
        assert a["verify_max_abs_diff"] == 0.0
        program = torch.export.load(os.path.join(d, name))
        called = {str(n.target).split(".")[1] for n in program.graph.nodes
                  if str(n.target).startswith("climsim_tpu_torch.")}
        assert called == WANT_OPS[preset]
        x = _columns(meta, a["batch"], seed=9)
        PK.reset_launches()
        with torch.inference_mode():
            y = PW.load_aot(os.path.join(d, name))(x)
            again = program.module()(x)
        assert PK.LAUNCHES == dict.fromkeys(PK.LAUNCHES, 0)  # the CPU
        assert y.shape == (a["batch"], 368) and torch.isfinite(y).all()
        torch.testing.assert_close(y, again, rtol=0, atol=0)


def test_bundle_metadata(bundles):
    d, meta = bundles["unet_v5"]
    assert meta["scheme"] == "two_stage" and meta["platform"] == "cpu"
    assert (meta["input_version"], meta["norm_space"]) == ("v4", "v5")
    assert meta["n_features"] == 1525 and meta["n_outputs"] == 368
    assert meta["norms"] == {"source": {"asset": "norms_v5.npz"},
                             "lengths": {"inp_sub": 1405, "inp_div": 1405,
                                         "out_scale": 308, "lbd_qn": 60}}
    assert sorted(meta["norm_files"]) == ["inp_div.txt", "inp_sub.txt",
                                          "lbd_qn.txt", "out_scale.txt"]
    for name, entry in {**meta["norm_files"], **meta["artifacts"]}.items():
        assert entry["sha256"] == P._sha256(os.path.join(d, name))
        assert entry["bytes"] == os.path.getsize(os.path.join(d, name))
    assert meta["untrained"] is False
    assert meta["param_count"] == sum(
        p.numel() for f in ("unet_v5.pt", "unet_v5_classifier.pt")
        for p in torch.load(os.path.join(os.path.dirname(d), f)).values())
    mlp = bundles["mlp_v2rh"][1]
    assert (mlp["input_version"], mlp["norm_space"]) == ("v2_rh", "v2_rh")
    assert sorted(a["batch"] for a in mlp["artifacts"].values()) == [8, 16]
    assert bundles["unet_v4"][1]["transform"] == \
        {**bundles["unet_v4"][1]["transform"], "qn_transform": False}


def test_bundle_takes_the_norms_it_is_given(tmp_path):
    """--norms: the bundle's txt files and metadata are the given npz's;
    norms of another feature space are refused."""
    stats = load_asset_norms("v2_rh")
    moved = NormStats(inp_sub=stats.inp_sub + 1.0, inp_div=stats.inp_div,
                      out_scale=2.0 * stats.out_scale)
    path = str(tmp_path / "trained.npz")
    moved.save_npz(path)
    meta = P.build_bundle("mlp_v2rh", None, str(tmp_path / "b"), [4],
                          overrides=TINY_MLP, norms=path, device="cpu")
    assert meta["norms"]["source"]["path"] == path
    assert meta["norms"]["source"]["sha256"] == P._sha256(path)
    got = np.loadtxt(tmp_path / "b" / "inp_sub.txt", delimiter=",")
    np.testing.assert_allclose(got, moved.inp_sub, rtol=1e-6)
    load_asset_norms("v5").save_npz(str(tmp_path / "v5.npz"))
    with pytest.raises(SystemExit, match="1405 inputs"):
        P.build_bundle("mlp_v2rh", None, str(tmp_path / "c"), [4],
                       overrides=TINY_MLP, norms=str(tmp_path / "v5.npz"),
                       device="cpu")


@pytest.mark.parametrize("version", ["v2_rh", "v4", "v5"])
def test_norm_files_match_jax(tmp_path, version):
    """save_txt writes the JAX package's txt files byte for byte, and
    lbd_qn.txt as its packager does; save_npz round-trips."""
    stats = load_asset_norms(version)
    stats.save_txt(str(tmp_path / "port"))
    jax_norms(version).save_txt(str(tmp_path / "jax"))
    for f in ("inp_sub.txt", "inp_div.txt", "out_scale.txt"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    lbd = tmp_path / "port" / "lbd_qn.txt"
    assert lbd.exists() == (stats.lbd_qn is not None)
    if stats.lbd_qn is not None:
        np.savetxt(tmp_path / "jax" / "lbd_qn.txt",
                   stats.lbd_qn.reshape(1, -1), fmt="%.6e", delimiter=",")
        assert lbd.read_bytes() == (tmp_path / "jax" / "lbd_qn.txt"
                                    ).read_bytes()
    stats.save_npz(str(tmp_path / "s.npz"))
    back = NormStats.from_npz(str(tmp_path / "s.npz"))
    for k in ("inp_sub", "inp_div", "out_scale", "lbd_qn", "lbd_qc",
              "lbd_qi"):
        a, b = getattr(stats, k), getattr(back, k)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_serve_bundle(bundles):
    """--bundle serves the program of the bucket asked for over the TCP
    bridge, and refuses a bucket the bundle lacks, naming the ones it
    has, and a device it was not exported for."""
    d, meta = bundles["mlp_v2rh"]
    with pytest.raises(ValueError, match=r"its buckets are \[8, 16\]"):
        serve.resolve_bundle(d, 12)
    with pytest.raises(SystemExit):
        serve.main(["--bundle", d, "--batch", "32", "--device", "cpu"])
    with pytest.raises(ValueError, match="run on cpu"):
        serve.make_server(serve.parse_args(["--bundle", d, "--batch", "8",
                                            "--device", "meta"]))
    srv, what = serve.make_server(serve.parse_args(
        ["--bundle", d, "--batch", "16", "--port", "0", "--device", "cpu"]))
    assert srv.buckets == [16] and what.endswith("wrapper_b16.pt2")
    srv.start()
    try:
        cl = CouplingClient("127.0.0.1", srv.port)
        x = _columns(meta, 5).numpy()
        y = cl.step(x)
        cl.close()
    finally:
        srv.stop()
    program = PW.load_aot(os.path.join(d, "wrapper_b16.pt2"))
    with torch.inference_mode():
        want = program(torch.from_numpy(np.pad(x, ((0, 11), (0, 0)))))[:5]
    np.testing.assert_array_equal(y, want.numpy())


def test_compute_norms_match_jax():
    """Norms computed from synthetic columns, as the JAX package computes
    them without its qn_transform (float64 on both sides, rtol 1e-12)."""
    from climsim_tpu.norms import compute_norms_from_data as jax_compute
    from climsim_tpu_torch.data.synthetic import synthetic_split
    from climsim_tpu_torch.norms import compute_norms_from_data

    spec = get_varspec("v2_rh")
    x, y = synthetic_split(spec, 512, load_default_grid(), seed=4)
    got, want = compute_norms_from_data(spec, x, y), jax_compute(spec, x, y)
    for k in ("inp_sub", "inp_div", "out_scale"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-12, atol=0)
    assert got.lbd_qn is None and want.lbd_qn is None
    with pytest.raises(ValueError, match="557 inputs"):
        compute_norms_from_data(get_varspec("v5"), x, y)


def test_program_holds_the_engines_prepared_weights(tmp_path):
    """The U-Net engine prepares its weights before a program is traced,
    never while (tracing a cold engine raises), and the program keeps the
    prepared kernels -- bf16 (3, C, Cout) for kernel 5 -- not the module's
    float32 conv weights."""
    from functools import partial

    from climsim_tpu_torch.ops.unet_infer import unet_apply_fused

    c = PRESETS["unet_v5"].override(*TINY_UNET)
    m = build_model(c.model, get_varspec("v5"), **c.model_kw,
                    compute_dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0)).eval()
    x = torch.zeros(4, get_varspec("v5").input_len)
    with pytest.raises(RuntimeError, match="run the model once first"):
        torch.export.export(PW._Program(partial(unet_apply_fused, m)), (x,))
    program = PW.export_aot(partial(unet_apply_fused, m), 4, x.shape[1],
                            str(tmp_path / "engine.pt2"), device="cpu")
    held = list(program.constants.values()) + list(
        program.state_dict.values())
    kernels = [t for t in held if t.dtype == torch.bfloat16 and t.dim() == 3]
    n_fused = sum(1 for n in program.graph.nodes
                  if "fused_gn_silu_conv3" in str(n.target))
    assert n_fused > 0 and len(kernels) >= n_fused
    assert all(t.shape[0] == 3 for t in kernels)
    # without the float32 copy of those weights: fewer bytes than the
    # module's parameters
    assert sum(t.numel() * t.element_size() for t in held) < sum(
        p.numel() * p.element_size() for p in m.parameters())


def _norm_run(tmp_path, norms):
    """A tiny mlp_v2rh run of python -m climsim_tpu_torch.run with
    data.norms=``norms``, checkpointed (top-K) into tmp_path / norms."""
    from climsim_tpu_torch import run as PRUN

    ck = tmp_path / norms
    out = PRUN.run_experiment(PRESETS["mlp_v2rh"].override(
        *TINY_MLP, f"data.norms={norms}", "data.num_synthetic=256",
        "data.batch_size=64", "train.epochs=1",
        f'train.checkpoint_dir="{ck}"'), verbose=False, device="cpu")
    return str(ck), out


def test_computed_norms_run_without_its_npz_is_refused(tmp_path):
    """A data.norms=compute run bundled without the norms it trained with
    (the npz beside its manifest gone) and no --norms: refused."""
    from climsim_tpu_torch.norms import RUN_NORMS

    ck, _ = _norm_run(tmp_path, "compute")
    with open(os.path.join(ck, "run_manifest.json")) as f:
        assert json.load(f)["norms"] == {"mode": "compute",
                                         "file": RUN_NORMS}
    os.remove(os.path.join(ck, RUN_NORMS))
    with pytest.raises(SystemExit, match="data.norms=compute"):
        P.build_bundle("mlp_v2rh", ck, str(tmp_path / "b"), [8],
                       overrides=TINY_MLP, device="cpu")


def test_computed_norms_run_bundles_its_norms(tmp_path):
    """A data.norms=compute run bundled from its checkpoint directory
    takes the npz the run saved (the stats it trained on, bit for bit):
    the program replies as the live wrapper on those stats within
    BUNDLE_TOL * max(1, max|y|), and not as the asset norms' wrapper."""
    from climsim_tpu_torch.norms import RUN_NORMS

    ck, out = _norm_run(tmp_path, "compute")
    npz = os.path.join(ck, RUN_NORMS)
    saved = NormStats.from_npz(npz)
    for k in ("inp_sub", "inp_div", "out_scale"):
        np.testing.assert_array_equal(getattr(saved, k),
                                      getattr(out["stats"], k))
    meta = P.build_bundle("mlp_v2rh", ck, str(tmp_path / "b"), [8],
                          overrides=TINY_MLP, verify=True, device="cpu")
    assert meta["norms"]["source"] == {"run": os.path.abspath(npz),
                                       **P._file_entry(npz)}
    spec = get_varspec("v2_rh")
    cfg = PRESETS["mlp_v2rh"].override(*TINY_MLP)
    model = P._model(cfg, spec, ck, 0)
    x = _columns(meta, 8, seed=4)
    program = PW.load_aot(str(tmp_path / "b" / "wrapper_b8.pt2"))
    with torch.inference_mode():
        got = program(x)
        want = PW.make_v2rh_wrapper(model, saved, spec, tcfg=cfg.transform,
                                    device="cpu")(x)
        asset = PW.make_v2rh_wrapper(model, load_asset_norms("v2_rh"), spec,
                                     tcfg=cfg.transform, device="cpu")(x)
    limit = BUNDLE_TOL * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= limit
    assert float((got - asset).abs().max()) > limit


def test_asset_norms_run_bundles_as_before(tmp_path):
    """A data.norms=asset run: the bundle takes the packaged asset, as
    before the run saved its norms."""
    ck, _ = _norm_run(tmp_path, "asset")
    meta = P.build_bundle("mlp_v2rh", ck, str(tmp_path / "b"), [8],
                          overrides=TINY_MLP, device="cpu")
    assert meta["norms"]["source"] == {"asset": "norms_v2_rh.npz"}
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "b" / "inp_sub.txt", delimiter=","),
        np.loadtxt(str(_asset_txt(tmp_path)), delimiter=","))


def _asset_txt(tmp_path):
    load_asset_norms("v2_rh").save_txt(str(tmp_path / "asset"))
    return tmp_path / "asset" / "inp_sub.txt"

"""The port's package boundary: it imports no jax, its kernel module imports
and builds nothing without a CUDA toolkit, and a kernel entry given a CPU
tensor takes the plain version and launches nothing."""

import functools
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from climsim_tpu_torch.ops import fused_mlp_train as FT
from climsim_tpu_torch.ops import kernels as PK
from climsim_tpu_torch.ops import unet_fused as PU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = (
    "climsim_tpu_torch", "climsim_tpu_torch.physics",
    "climsim_tpu_torch.data.synthetic", "climsim_tpu_torch.data.transforms",
    "climsim_tpu_torch.ops.kernels", "climsim_tpu_torch.ops._build",
    "climsim_tpu_torch.models", "climsim_tpu_torch.models.common",
    "climsim_tpu_torch.models.mlp", "climsim_tpu_torch.models.unet",
    "climsim_tpu_torch.ops.unet_fused", "climsim_tpu_torch.ops.unet_infer",
    "climsim_tpu_torch.utils.migrate",
    "climsim_tpu_torch.online.wrapper", "climsim_tpu_torch.online.server",
    "climsim_tpu_torch.serve", "climsim_tpu_torch.ops.fused_mlp_train",
    "climsim_tpu_torch.data.pipeline", "climsim_tpu_torch.train.losses",
    "climsim_tpu_torch.train.schedules", "climsim_tpu_torch.train.step",
    "climsim_tpu_torch.train.recipes", "climsim_tpu_torch.bench_train",
    "climsim_tpu_torch.varspec", "climsim_tpu_torch.norms",
    "climsim_tpu_torch.grid", "climsim_tpu_torch.bench_unet_train",
    "climsim_tpu_torch.config", "climsim_tpu_torch.online.two_stage",
    "climsim_tpu_torch.train.checkpoints", "climsim_tpu_torch.train.loop",
    "climsim_tpu_torch.package_e3sm", "climsim_tpu_torch.ops",
    "climsim_tpu_torch.online.driver", "climsim_tpu_torch.online_coupling",
    "climsim_tpu_torch.eval", "climsim_tpu_torch.eval.metrics",
    "climsim_tpu_torch.eval.weighting", "climsim_tpu_torch.eval.scoring",
    "climsim_tpu_torch.eval.streaming", "climsim_tpu_torch.eval.cli",
    "climsim_tpu_torch.eval.online_diags", "climsim_tpu_torch.eval.analysis",
    "climsim_tpu_torch.utils.io", "climsim_tpu_torch.utils.ncread",
    "climsim_tpu_torch.data.h5dataset", "climsim_tpu_torch.data.statistics",
    "climsim_tpu_torch.data.kaggle", "climsim_tpu_torch.data.ingest",
    "climsim_tpu_torch.data.native", "climsim_tpu_torch.bench_chunked",
    "climsim_tpu_torch.bench_server", "climsim_tpu_torch.quickstart",
    "climsim_tpu_torch.models.ed", "climsim_tpu_torch.models.hsr",
    "climsim_tpu_torch.models.cvae", "climsim_tpu_torch.models.cnn",
    "climsim_tpu_torch.models.rpn", "climsim_tpu_torch.train.multiseed",
    "climsim_tpu_torch.train.rpn_recipe", "climsim_tpu_torch.run",
    "climsim_tpu_torch.bench_cnn", "climsim_tpu_torch.utils.flax_migrate",
    "climsim_tpu_torch.train.hpo", "climsim_tpu_torch.parallel",
    "climsim_tpu_torch.parallel.mesh", "climsim_tpu_torch.train.step_shardmap",
    "climsim_tpu_torch.utils.profiling", "climsim_tpu_torch.run_hpo_sweep",
    "climsim_tpu_torch.train.elastic", "climsim_tpu_torch.run_all_baselines",
    "climsim_tpu_torch.make_offline_figures",
    "climsim_tpu_torch.run_real_baselines", "climsim_tpu_torch.bench_ingest",
    "climsim_tpu_torch.bench_all", "climsim_tpu_torch.data.synthnc",
)

# the port's byte-for-byte copies of the JAX package's numpy-only modules
# and of the native loader's C++ source: (port file, its source)
BYTE_COPIES = (
    ("climsim_tpu_torch/utils/io.py", "climsim_tpu/utils/io.py"),
    ("climsim_tpu_torch/utils/ncread.py", "climsim_tpu/utils/ncread.py"),
    ("climsim_tpu_torch/data/h5dataset.py", "climsim_tpu/data/h5dataset.py"),
    ("climsim_tpu_torch/data/statistics.py",
     "climsim_tpu/data/statistics.py"),
    ("climsim_tpu_torch/data/kaggle.py", "climsim_tpu/data/kaggle.py"),
    ("climsim_tpu_torch/data/ingest.py", "climsim_tpu/data/ingest.py"),
    ("climsim_tpu_torch/data/csrc/climload.cpp", "runtime/climload.cpp"),
    ("climsim_tpu_torch/utils/flax_migrate.py", "climsim_tpu/utils/migrate.py"),
    ("climsim_tpu_torch/train/hpo.py", "climsim_tpu/train/hpo.py"),
    ("climsim_tpu_torch/data/synthnc.py", "tests/synthnc.py"),
)


def _run(code: str, **env) -> str:
    """Run ``code`` in a fresh interpreter (this one has jax loaded)."""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={**os.environ, **env})
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "import climsim_tpu_torch as p\n"
            "p.get_varspec('v2_rh'); p.load_asset_norms('v2_rh')\n"
            "p.load_default_grid()\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
            "print(bad)\n")
    assert _run(code).strip() == "[]"


def test_port_imports_nothing_of_the_jax_package():
    """The registry, norms and grid are the port's own copies: after every
    slice module is imported and used, no module of ``climsim_tpu`` is
    loaded."""
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "import climsim_tpu_torch as p\n"
            "for v in ('v1', 'v2_rh', 'v4', 'v5'):\n"
            "    p.get_varspec(v); p.load_asset_norms(v)\n"
            "p.load_default_grid()\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] == 'climsim_tpu'))\n")
    assert _run(code).strip() == "[]"


def test_copies_equal_the_jax_package():
    """Every registered spec field by field, every norms asset and the
    grid bit for bit, the grid's evaluation properties, every function
    of the copied eval modules on seeded inputs (one case of
    test_torch_eval.CASES a function; that file runs them all), and each
    of BYTE_COPIES byte for byte (test_torch_ingest.py and
    test_torch_native.py run them against the JAX package)."""
    for ours, src in BYTE_COPIES:
        with open(os.path.join(ROOT, ours), "rb") as a, \
                open(os.path.join(ROOT, src), "rb") as b:
            assert a.read() == b.read(), ours
    from climsim_tpu import grid as JG
    from climsim_tpu import norms as JN
    from climsim_tpu import varspec as JV
    from climsim_tpu_torch import grid as PG
    from climsim_tpu_torch import norms as PN
    from climsim_tpu_torch import varspec as PV

    assert PV.available() == JV.available()
    assert PV.NUM_LEVELS == JV.NUM_LEVELS
    for name in JV.available():
        j, p = JV.get_varspec(name), PV.get_varspec(name)
        for field in ("name", "inputs", "outputs", "input_len",
                      "output_len", "input_slices", "output_slices",
                      "input_profile_vars", "input_scalar_vars",
                      "output_profile_vars", "output_scalar_vars"):
            assert getattr(p, field) == getattr(j, field), (name, field)
        if "state_ps" in j.inputs:
            assert p.ps_index == j.ps_index
        for v in j.inputs + j.outputs:
            assert PV.var_len(v) == JV.var_len(v)
    assets = sorted(f.name for f in (Path(PN.__file__).parent
                                     / "assets").iterdir())
    assert len(assets) == 6
    for f in assets:
        if not f.startswith("norms_"):
            continue
        v = f[len("norms_"):-len(".npz")]
        j, p = JN.load_asset_norms(v), PN.load_asset_norms(v)
        for field in ("inp_sub", "inp_div", "out_scale", "lbd_qn", "lbd_qc",
                      "lbd_qi"):
            a, b = getattr(j, field), getattr(p, field)
            assert (a is None) == (b is None), (v, field)
            if a is not None:
                assert a.dtype == b.dtype, (v, field)
                np.testing.assert_array_equal(a, b)
    jg, pg = JG.load_default_grid(), PG.load_default_grid()
    for field in ("lat", "lon", "area", "hyai", "hybi", "hyam", "hybm"):
        a, b = getattr(jg, field), getattr(pg, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert jg.p0 == pg.p0
    assert (pg.ncol, pg.num_levels) == (jg.ncol, jg.num_levels)
    for field in ("area_wgt", "unique_lats"):
        np.testing.assert_array_equal(getattr(pg, field), getattr(jg, field))
    for a, b in zip(pg.lat_indices(), jg.lat_indices(), strict=True):
        np.testing.assert_array_equal(a, b)
    assert pg.replace(p0=1.0).p0 == 1.0 and pg.p0 == jg.p0

    # the zoo's helpers: seed_spread, and the channelized and UTLS index
    # layouts (the JAX functions applied to a row of column numbers)
    from climsim_tpu.data import transforms as JT
    from climsim_tpu.train import multiseed as JMS
    from climsim_tpu_torch.data import transforms as PT
    from climsim_tpu_torch.train import multiseed as PMS

    preds = np.random.default_rng(3).standard_normal((3, 5, 7))
    for k, v in JMS.seed_spread(preds).items():
        np.testing.assert_array_equal(PMS.seed_spread(preds)[k], v)
    for name in JV.available():
        j = JV.get_varspec(name)
        p = PV.get_varspec(name)
        for which, fn in (("inputs", JT.channelize_input),
                          ("outputs", JT.channelize_target)):
            n = j.input_len if which == "inputs" else j.output_len
            cols = np.asarray(fn(np.arange(n, dtype=np.float64)[None], j))[0]
            np.testing.assert_array_equal(PT.channel_indices(p, which),
                                          cols)
        if "pbuf_ozone" in j.inputs:
            np.testing.assert_array_equal(PT.utls_feature_indices(p),
                                          JT.utls_feature_indices(j))

    import test_torch_eval as TE

    first = {}
    for case, (fn, _, _) in sorted(TE.CASES.items()):
        first.setdefault(fn, case)
    for mod, (jm, pm) in TE.MODULES.items():
        names = {n for n, f in inspect.getmembers(jm, inspect.isfunction)
                 if f.__module__ == jm.__name__}
        assert names == {n for n, f in inspect.getmembers(
            pm, inspect.isfunction) if f.__module__ == pm.__name__}, mod
        for n in sorted(names - TE.PLOTTING):
            TE.run_case(first[f"{mod}.{n}"])


def _entry_points():
    """name -> a call of the entry point with every argument but the
    device."""
    from climsim_tpu_torch.data import native as PN
    from climsim_tpu_torch.data import pipeline as PP
    from climsim_tpu_torch.data import transforms as PT
    from climsim_tpu_torch.data.pipeline import DeviceResidentLoader
    from climsim_tpu_torch.models import OnlineMLP
    from climsim_tpu_torch.norms import load_asset_norms
    from climsim_tpu_torch.online import wrapper as PW
    from climsim_tpu_torch.online.server import CouplingServer
    from climsim_tpu_torch.train import losses as PL
    from climsim_tpu_torch.train import recipes as PR
    from climsim_tpu_torch.online.two_stage import make_two_stage_apply
    from climsim_tpu_torch.grid import load_default_grid
    from climsim_tpu_torch.online import driver as PD
    from climsim_tpu_torch.online_coupling import run_coupling
    from climsim_tpu_torch.package_e3sm import build_bundle
    from climsim_tpu_torch.varspec import get_varspec
    from climsim_tpu_torch import run as PRUN
    from climsim_tpu_torch.config import PRESETS
    from climsim_tpu_torch.train import rpn_recipe as PRR

    spec, stats = get_varspec("v2_rh"), load_asset_norms("v2_rh")
    grid = load_default_grid()
    v4 = np.full((2, get_varspec("v4").input_len), 1.0, np.float32)
    spec5, stats5 = get_varspec("v5"), load_asset_norms("v5")
    mlp = OnlineMLP(spec, hidden=(8,))
    tiny = dict(model_channels=8, channel_mult=(1,), num_blocks=1,
                attn_resolutions=())
    x = np.zeros((32, 4), np.float32)
    v1x = np.zeros((1280, 124), np.float32)
    v1y = np.zeros((1280, 128), np.float32)
    from climsim_tpu_torch import bench_all as PBA
    from climsim_tpu_torch import run_all_baselines as PRAB
    return {
        "mlp_trainer": lambda: PR.mlp_trainer(
            get_varspec("v1"), load_asset_norms("v1"), None, 0, hidden=(8,)),
        "online_mlp_trainer": lambda: PR.online_mlp_trainer(
            spec, stats, None, 0, hidden=(8,)),
        "unet_trainer": lambda: PR.unet_trainer(
            spec5, stats5, None, 0, model_kw=tiny),
        "unet_classifier_trainer": lambda: PR.unet_classifier_trainer(
            spec5, stats5, None, 0, model_kw=tiny),
        "DeviceResidentLoader": lambda: DeviceResidentLoader(x, x, 8),
        "make_input_transform": lambda: PT.make_input_transform(spec, stats),
        "make_target_transform": lambda: PT.make_target_transform(spec,
                                                                  stats),
        "input_transform_consts": lambda: PT.input_transform_consts(spec,
                                                                    stats),
        "make_wrapper": lambda: PW.make_wrapper(lambda xn: xn, stats5),
        "make_v2rh_wrapper": lambda: PW.make_v2rh_wrapper(mlp, stats, spec),
        "make_fast_mlp_wrapper": lambda: PW.make_fast_mlp_wrapper(
            mlp, stats, spec),
        "CouplingServer": lambda: CouplingServer(lambda x: x, 4),
        "block_weight_vector": lambda: PL.block_weight_vector(spec,
                                                              {"2d": 2.0}),
        "constraint_head_consts": lambda: PK.constraint_head_consts(
            np.ones(308), 15),
        "pack_mlp": lambda: PK.pack_mlp([np.zeros((4, 2), np.float32)],
                                        [np.zeros(2, np.float32)]),
        "make_v4_wrapper": lambda: PW.make_v4_wrapper(
            lambda xn: xn, load_asset_norms("v4")),
        "make_two_stage_apply": lambda: make_two_stage_apply(
            lambda xn: xn, lambda xn: xn, stats5),
        "export_aot": lambda: PW.export_aot(lambda x: x, 2, 4, os.devnull),
        "build_bundle": lambda: build_bundle(
            "mlp_v2rh", None, os.devnull, [4],
            overrides=("model_kw.hidden=[8]",)),
        "initial_state": lambda: PD.initial_state(v4, grid),
        "newtonian_relaxation": lambda: PD.newtonian_relaxation(
            v4[:, :60], v4[:, :60], v4[:, :60], 144.0, lat=grid.lat[:2],
            diurnal_amp_k_per_day=1.5),
        "run_coupling": lambda: run_coupling(steps=1, train_steps=1),
        "BatchLoader": lambda: PP.BatchLoader(x, x, 8),
        "ChunkedLoader": lambda: PP.ChunkedLoader(x, x, 4, 2),
        "BootstrapLoader": lambda: PP.BootstrapLoader(x, x, 4, 2),
        "NativeLoader": lambda: PN.NativeLoader(os.devnull, os.devnull, 8),
        "make_loader": lambda: PN.make_loader(os.devnull, os.devnull, 8),
        **{f"{m}_trainer": functools.partial(
            getattr(PR, f"{m}_trainer"), get_varspec("v1"),
            load_asset_norms("v1"), None, 0, **kw)
           for m, kw in (("mlp_v2", {}), ("ed", {}),
                         ("cnn", dict(depth=1, channels=8)),
                         ("hsr", dict(hidden=8, layers=1)),
                         ("cvae", dict(hidden=8, layers=1)))},
        "rpn_trainer": lambda: PRR.rpn_trainer(
            get_varspec("v1"), load_asset_norms("v1"), None, 0,
            ensemble_size=2, hidden=(8,)),
        "make_subset_transform": lambda: PT.make_subset_transform(
            np.arange(3)),
        "train_and_score": lambda: PRAB.train_and_score(
            get_varspec("v1"), grid, load_asset_norms("v1"), v1x, v1y, v1x,
            v1y, epochs=1),
        "bench_generic": lambda: PBA.bench_generic(
            "MLP", lambda s, st, sb, r, device: PR.mlp_trainer(
                s, st, sb, r, hidden=(8,), device=device),
            "v1", 16, 128, [], epoch_rows=16),
        "bench_rpn": lambda: PBA.bench_rpn([], 2, 16, 128, epoch_rows=16),
        "run_experiment": lambda: PRUN.run_experiment(
            PRESETS["mlp_v1"].override('model_kw={"hidden": [8]}',
                                       "data.num_synthetic=64",
                                       "data.batch_size=16",
                                       "train.epochs=1"), verbose=False),
    }


ENTRY_POINTS = ("mlp_trainer", "online_mlp_trainer", "unet_trainer",
                "unet_classifier_trainer", "DeviceResidentLoader",
                "make_input_transform", "make_target_transform",
                "input_transform_consts", "make_wrapper",
                "make_v2rh_wrapper", "make_fast_mlp_wrapper",
                "CouplingServer", "block_weight_vector",
                "constraint_head_consts", "pack_mlp", "make_v4_wrapper",
                "make_two_stage_apply", "export_aot", "build_bundle",
                "initial_state", "newtonian_relaxation", "run_coupling",
                "BatchLoader", "ChunkedLoader", "BootstrapLoader",
                "NativeLoader", "make_loader", "mlp_v2_trainer",
                "ed_trainer", "cnn_trainer", "hsr_trainer", "cvae_trainer",
                "rpn_trainer", "make_subset_transform", "run_experiment",
                "train_and_score", "bench_generic", "bench_rpn")


def _default_device(name):
    from climsim_tpu_torch.data import transforms as PT
    from climsim_tpu_torch.data.pipeline import DeviceResidentLoader
    from climsim_tpu_torch.online import wrapper as PW
    from climsim_tpu_torch.online.server import CouplingServer
    from climsim_tpu_torch.train import losses as PL
    from climsim_tpu_torch.train import recipes as PR
    from climsim_tpu_torch import online_coupling as PC
    from climsim_tpu_torch import package_e3sm as PP
    from climsim_tpu_torch.online import driver as PD
    from climsim_tpu_torch.online import two_stage as PS

    from climsim_tpu_torch.data import native as PN
    from climsim_tpu_torch.data import pipeline as PDP
    from climsim_tpu_torch import run as PRUN
    from climsim_tpu_torch.train import rpn_recipe as PRR
    from climsim_tpu_torch import bench_all as PBA
    from climsim_tpu_torch import run_all_baselines as PRAB

    for mod in (PR, PT, PW, PL, PK, PP, PS, PD, PC, PDP, PN, PRR, PRUN,
                PRAB, PBA):
        if hasattr(mod, name):
            fn = getattr(mod, name)
            break
    else:
        fn = {"DeviceResidentLoader": DeviceResidentLoader,
              "CouplingServer": CouplingServer}[name]
    return inspect.signature(fn).parameters["device"].default


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name):
    """Each entry point takes ``device="cuda"`` by default.  Without a card
    that default raises (torch's own error): it never quietly runs on the
    CPU."""
    assert _default_device(name) == "cuda"
    call = _entry_points()[name]
    if torch.cuda.is_available():
        call()
        return
    with pytest.raises((AssertionError, RuntimeError)):
        call()


def test_kernels_import_without_toolkit(tmp_path):
    """No nvcc on PATH, no CUDA_HOME: the kernel module still imports,
    importing loads no library, and a build is refused with a clear
    error rather than half-done."""
    code = ("from climsim_tpu_torch.ops import _build, kernels\n"
            "from climsim_tpu_torch.ops import fused_mlp_train\n"
            "assert _build._lib is None\n"
            "assert {'cst_fused_mlp_train_fwd',\n"
            "        'cst_fused_mlp_train_bwd'} <= set(_build._SIGNATURES)\n"
            "from torch.utils.cpp_extension import CUDA_HOME\n"
            "if CUDA_HOME is not None:\n"
            "    print('toolkit present')\n"
            "else:\n"
            "    try:\n"
            "        _build.build()\n"
            "    except RuntimeError as e:\n"
            "        print('refused:', e)\n")
    env = {"PATH": str(tmp_path), "CUDA_HOME": "", "CUDA_PATH": ""}
    out = _run(code, **env).strip()
    assert out.startswith(("refused: no CUDA toolkit", "toolkit present"))


def _mlp(wdtype):
    rng = np.random.default_rng(0)
    ws = [rng.standard_normal((12, 16)).astype(np.float32),
          rng.standard_normal((16, 6)).astype(np.float32)]
    bs = [np.zeros(16, np.float32), np.zeros(6, np.float32)]
    return PK.pack_mlp(ws, bs, wdtype, device="cpu")


def _consts(d):
    z, o = np.zeros(d), np.ones(d)
    return PK.transform_consts(sub=z, divinv=o, mask=o, lo=-np.inf * o,
                               hi=np.inf * o, lbd=z, is_cloud=z,
                               device="cpu")


def _gn_args(c=32, cout=16, wdtype=torch.bfloat16):
    g = torch.Generator().manual_seed(1)
    return (torch.randn(3, 8, c, generator=g), torch.ones(c), torch.zeros(c),
            torch.randn(3, c, cout, generator=g).to(wdtype),
            torch.zeros(cout))


def _head_args(b=5):
    g = torch.Generator().manual_seed(2)
    return (torch.randn(b, 308, generator=g),
            260 + 30 * torch.rand(b, 60, generator=g),
            1e-5 * torch.rand(b, 60, generator=g),
            1e-5 * torch.rand(b, 60, generator=g),
            PK.constraint_head_consts(np.ones(308), 15,
                                        device="cpu"))


@pytest.mark.parametrize("entry", ["fused_input_transform",
                                   "fused_mlp_forward",
                                   "fused_mlp_forward_int8",
                                   "fused_constraint_head",
                                   "fused_gn_silu_conv3",
                                   "fused_mlp_train_fwd",
                                   "fused_mlp_train_bwd"])
def test_cpu_tensor_takes_plain_path(entry):
    PK.reset_launches()
    x = torch.randn(5, 12, generator=torch.Generator().manual_seed(0))
    if entry.startswith("fused_mlp_train"):
        m = _mlp(torch.float32)
        ws = [w.reshape(i, o) for w, i, o in (
            (m.w[:12 * 16], 12, 16), (m.w[12 * 16:], 16, 6))]
        bs = [m.b[:16], m.b[16:]]
        if entry.endswith("fwd"):
            got, want = FT.fused_mlp_train_fwd(x, ws, bs), \
                FT.fused_mlp_train_fwd_plain(x, ws, bs)
        else:
            dy = torch.ones(5, 6)
            got, want = (torch.cat([t.flatten() for t in ts]) for ts in (
                sum(FT.fused_mlp_train_bwd(x, dy, ws, bs, 2), []),
                sum(FT.fused_mlp_train_bwd_plain(x, dy, ws, bs), [])))
    elif entry == "fused_constraint_head":
        a = _head_args()
        got, want = PK.fused_constraint_head(*a, 1200.0), \
            PK.fused_constraint_head_plain(*a, 1200.0)
    elif entry == "fused_gn_silu_conv3":
        a = _gn_args()
        got, want = PU.fused_gn_silu_conv3(*a), \
            PU.xla_gn_silu_conv3_plain(*a)
    elif entry == "fused_input_transform":
        c = _consts(12)
        got, want = PK.fused_input_transform(x, c), \
            PK.fused_input_transform_plain(x, c)
    elif entry == "fused_mlp_forward":
        m = _mlp(torch.bfloat16)
        got, want = PK.fused_mlp_forward(x, m, 2), \
            PK.fused_mlp_forward_plain(x, m, 2)
    else:
        m = _mlp("int8")
        got, want = PK.fused_mlp_forward_int8(x, m, 2), \
            PK.fused_mlp_forward_int8_plain(x, m, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert PK.LAUNCHES == dict.fromkeys(PK.LAUNCHES, 0)


def test_kernel_entries_reject_bad_inputs():
    x = torch.zeros(4, 12)
    with pytest.raises(TypeError):
        PK.fused_input_transform(x.double(), _consts(12))
    with pytest.raises(ValueError):
        PK.fused_input_transform(torch.zeros(4, 11), _consts(12))
    with pytest.raises(ValueError):
        PK.fused_input_transform(torch.zeros(12, 4).t(), _consts(4))
    with pytest.raises(TypeError):
        PK.fused_mlp_forward(x, _mlp("int8"))          # int8 needs its entry
    with pytest.raises(TypeError):
        PK.fused_mlp_forward_int8(x, _mlp(torch.bfloat16))
    with pytest.raises(ValueError):
        PK.fused_mlp_forward(torch.zeros(4, 13), _mlp(torch.float32))
    with pytest.raises(ValueError):
        PK.fused_mlp_forward(x, _mlp(torch.float32), relu_tail=7)
    with pytest.raises(ValueError):
        PK.pack_mlp([np.zeros((12, 16))], [np.zeros(15)], device="cpu")
    with pytest.raises(ValueError):
        PK.pack_mlp([np.zeros((12, 16))], [np.zeros(16)], torch.float16,
                    device="cpu")
    with pytest.raises(ValueError):
        PK.PackedMLP((12, 16), torch.zeros(12 * 15), torch.zeros(16))
    ws, bs = [torch.zeros(12, 16), torch.zeros(16, 6)], [torch.zeros(16),
                                                        torch.zeros(6)]
    with pytest.raises(TypeError):
        FT.fused_mlp_train_fwd(x, [ws[0].double(), ws[1]], bs)
    with pytest.raises(ValueError):
        FT.fused_mlp_train_fwd(x, ws[:1], bs)
    with pytest.raises(ValueError):
        FT.fused_mlp_train_bwd(x, torch.zeros(4, 5), ws, bs)
    with pytest.raises(ValueError):
        FT.fused_mlp_train_bwd(x, torch.zeros(4, 6), ws, bs, tile_b=0)


def test_unet_kernel_entries_reject_bad_inputs():
    x, gamma, beta, w, b = _gn_args()
    with pytest.raises(TypeError):
        PU.fused_gn_silu_conv3(x.double(), gamma, beta, w, b)
    with pytest.raises(ValueError):
        PU.fused_gn_silu_conv3(x, gamma[:-1], beta, w, b)
    with pytest.raises(ValueError):
        PU.fused_gn_silu_conv3(x, gamma, beta, w[:, :-1], b)
    with pytest.raises(ValueError):
        PU.fused_gn_silu_conv3(x.transpose(0, 1), gamma, beta, w, b)
    with pytest.raises(TypeError):
        PU.fused_gn_silu_conv3(x, gamma, beta, w.half(), b)
    y, t, qc, qi, consts = _head_args()
    with pytest.raises(ValueError):
        PK.fused_constraint_head(y[:, :300].contiguous(), t, qc, qi, consts,
                                 1200.0)
    with pytest.raises(ValueError):
        PK.fused_constraint_head(y, t[:4], qc, qi, consts, 1200.0)
    with pytest.raises(TypeError):
        PK.fused_constraint_head(y, t, qc.double(), qi, consts, 1200.0)
    with pytest.raises(ValueError):
        PK.fused_constraint_head(y, t, qc, qi, consts, 0.0)


def test_tf32_is_off_for_products_and_convolutions():
    """Importing the models turns TF32 off for float32 matmuls and cuDNN
    convolutions alike (cuDNN's default is on)."""
    out = _run("import torch\n"
               "import climsim_tpu_torch.models\n"
               "print(torch.backends.cuda.matmul.allow_tf32,\n"
               "      torch.backends.cudnn.allow_tf32)\n")
    assert out.split() == ["False", "False"]


def test_packed_layout_is_row_major_concatenation():
    rng = np.random.default_rng(1)
    ws = [rng.standard_normal((3, 4)).astype(np.float32),
          rng.standard_normal((4, 2)).astype(np.float32)]
    bs = [np.arange(4, dtype=np.float32), np.arange(2, dtype=np.float32)]
    m = PK.pack_mlp(ws, bs, torch.float32, device="cpu")
    assert m.widths == (3, 4, 2)
    np.testing.assert_array_equal(
        m.w.numpy(), np.concatenate([w.reshape(-1) for w in ws]))
    np.testing.assert_array_equal(m.b.numpy(), np.concatenate(bs))
    q = PK.pack_mlp(ws, bs, "int8", device="cpu")
    assert q.w.dtype == torch.int8
    assert [tuple(s.shape) for _, _, s in q.layers()] == [(4,), (2,)]
    assert PK.pack_mlp(ws, bs, device="cpu").w.dtype == torch.bfloat16

"""The port's package boundary: it imports no jax, its kernel module imports
and builds nothing without a CUDA toolkit, and a kernel entry given a CPU
tensor takes the plain version and launches nothing."""

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
    grid bit for bit."""
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


def _entry_points():
    """name -> a call of the entry point with every argument but the
    device."""
    from climsim_tpu_torch.data import transforms as PT
    from climsim_tpu_torch.data.pipeline import DeviceResidentLoader
    from climsim_tpu_torch.models import OnlineMLP
    from climsim_tpu_torch.norms import load_asset_norms
    from climsim_tpu_torch.online import wrapper as PW
    from climsim_tpu_torch.online.server import CouplingServer
    from climsim_tpu_torch.train import losses as PL
    from climsim_tpu_torch.train import recipes as PR
    from climsim_tpu_torch.varspec import get_varspec

    spec, stats = get_varspec("v2_rh"), load_asset_norms("v2_rh")
    spec5, stats5 = get_varspec("v5"), load_asset_norms("v5")
    mlp = OnlineMLP(spec, hidden=(8,))
    tiny = dict(model_channels=8, channel_mult=(1,), num_blocks=1,
                attn_resolutions=())
    x = np.zeros((32, 4), np.float32)
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
    }


ENTRY_POINTS = ("mlp_trainer", "online_mlp_trainer", "unet_trainer",
                "unet_classifier_trainer", "DeviceResidentLoader",
                "make_input_transform", "make_target_transform",
                "input_transform_consts", "make_wrapper",
                "make_v2rh_wrapper", "make_fast_mlp_wrapper",
                "CouplingServer", "block_weight_vector",
                "constraint_head_consts", "pack_mlp")


def _default_device(name):
    from climsim_tpu_torch.data import transforms as PT
    from climsim_tpu_torch.data.pipeline import DeviceResidentLoader
    from climsim_tpu_torch.online import wrapper as PW
    from climsim_tpu_torch.online.server import CouplingServer
    from climsim_tpu_torch.train import losses as PL
    from climsim_tpu_torch.train import recipes as PR

    for mod in (PR, PT, PW, PL, PK):
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
    assert q.w.dtype == torch.int8 and q.scale.shape == (6,)
    assert PK.pack_mlp(ws, bs, device="cpu").w.dtype == torch.bfloat16

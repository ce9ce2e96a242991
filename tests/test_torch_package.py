"""The port's package boundary: it imports no jax, its kernel module imports
and builds nothing without a CUDA toolkit, and a kernel entry given a CPU
tensor takes the plain version and launches nothing."""

import os
import subprocess
import sys

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
    return PK.pack_mlp(ws, bs, wdtype)


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
            PK.constraint_head_consts(np.ones(308), 15))


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
            PU.fused_gn_silu_conv3_plain(*a)
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
        PK.pack_mlp([np.zeros((12, 16))], [np.zeros(15)])
    with pytest.raises(ValueError):
        PK.pack_mlp([np.zeros((12, 16))], [np.zeros(16)], torch.float16)
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
    m = PK.pack_mlp(ws, bs, torch.float32)
    assert m.widths == (3, 4, 2)
    np.testing.assert_array_equal(
        m.w.numpy(), np.concatenate([w.reshape(-1) for w in ws]))
    np.testing.assert_array_equal(m.b.numpy(), np.concatenate(bs))
    q = PK.pack_mlp(ws, bs, "int8")
    assert q.w.dtype == torch.int8 and q.scale.shape == (6,)
    assert PK.pack_mlp(ws, bs).w.dtype == torch.bfloat16

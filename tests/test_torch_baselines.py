"""The port's baseline entries (``run_all_baselines``,
``make_offline_figures``, ``run_real_baselines``) against the JAX scripts
on the CPU.

One run of each side's ``make_offline_figures.main`` (epochs 3, days 2:
48 x 384 training rows, 24 x 384 scoring rows) drives its
``train_and_score`` on the same synthetic v1 split, through
``BatchLoader`` and ``BootstrapLoader`` on both sides (their batches are
equal for a seed, test_torch_streaming.py).  Every trainer the JAX
function builds is recorded and ported into the port's (the porters of
``utils.migrate``), at float32 compute on both sides and narrowed widths
(the RPN's hidden widths too, which the script fixes at (256, 256));
CNN dropout off.  JAX's noise is fed where the port draws its own: the
cVAE's training eps, and the HSR and cVAE samples of PRNGKey(9).

Tolerances: the losses rtol 1e-4 (the train steps are rtol 1e-5 each,
test_torch_zoo_train.py); every MAE, RMSE, R2 and CRPS entry at
TABLE_RTOL, which says why it is looser; R2 as 1 - R2 (= sse / sst,
whose relative precision is sse's); the bias, a signed mean, within
TABLE_RTOL * MAE; the predictions and samples elementwise at PRED_ATOL.
The port's figure path is then fed the JAX run's tables and
predictions, so that its plotted arrays are held to the script's at
FIG_RTOL.  The JAX main draws nothing: its plotting functions are
replaced by ones that keep their arguments.  ~70 s: the JAX side
compiles six trainers."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.grid import load_default_grid as jax_grid
from climsim_tpu.train import recipes as JR
from climsim_tpu.train import rpn_recipe as JRR
from climsim_tpu.varspec import get_varspec as jax_varspec
from climsim_tpu_torch import make_offline_figures as PMOF
from climsim_tpu_torch import models as PMOD
from climsim_tpu_torch import run_all_baselines as PRAB
from climsim_tpu_torch import run_real_baselines as PRRB
from climsim_tpu_torch.eval import analysis as PA
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.models import cvae as PCVAE
from climsim_tpu_torch.models import hsr as PHSR
from climsim_tpu_torch.train import recipes as PR
from climsim_tpu_torch.train import rpn_recipe as PRR
from climsim_tpu_torch.utils import migrate as PM
from climsim_tpu_torch.varspec import get_varspec
from synthnc import make_tree
from test_torch_zoo_train import f32_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import make_offline_figures as JMOF  # noqa: E402  scripts/
import run_all_baselines as JRAB  # noqa: E402  scripts/
import run_real_baselines as JRRB  # noqa: E402  scripts/

RTOL = 1e-4
# the tables: not 1e-4.  The CNN takes 108 Adam steps and the MLP 54;
# float32 sums in another order differ by ~1e-7 a step, and Adam's
# normalized update turns such gaps into moves.  Over runs on the CPU
# the CNN's tables read 1.0e-4 to 1.9e-4 apart, the MLP's 5e-5, the
# others 3e-6 at most; the losses 1.1e-6
TABLE_RTOL = 5e-4
# elementwise predictions and samples: * max|JAX's|.  Not 1e-4: the ED's
# outputs after 54 Adam steps through its 13 layers are near its mean
# (max 0.024, near zero skill), and the float32 sums' other order leaves
# them up to 2.2e-4 of that apart; its tables hold at RTOL
PRED_ATOL = 1e-3
# the figure path from the same predictions: float64 numpy on both sides
# (the targets' float32 product may round apart by an ulp)
FIG_RTOL = 1e-6
F32 = torch.float32
EPOCHS, DAYS = 3, 2
# recipe -> (the narrowing both sides take, the porter)
NARROW = {
    "mlp": (dict(hidden=(32, 24)), PM.port_flax_mlp),
    "ed": ({}, PM.port_flax_ed),
    "cnn": (dict(depth=2, channels=16, dropout=0.0), PM.port_flax_cnn),
    "hsr": (dict(hidden=32, layers=2), PM.port_flax_hsr),
    "cvae": (dict(latent=4, hidden=32, layers=2), PM.port_flax_cvae),
}
ED_WIDTH = 32
RPN_HIDDEN = (32, 24)
CVAE_LATENT = 4
NUM_SAMPLES = 32


def _narrow_jax(mp, built):
    """The JAX recipes at float32 and narrow widths, each trainer's
    initial parameters (and the cVAE's state key) recorded in ``built``."""
    for cls, kw in (("ClimSimMLP", {}), ("ClimSimCNN", {}), ("HSR", {}),
                    ("CVAE", {}), ("EncoderDecoder",
                                   dict(intermediate=ED_WIDTH))):
        f32_model(mp, cls, **kw)
    for name, (kw, _) in NARROW.items():
        orig = getattr(JR, f"{name}_trainer")

        def make(*a, _orig=orig, _kw=kw, _name=name, **k):
            tr = _orig(*a, **{**k, **_kw})
            built.setdefault(_name, []).append(
                (jax.tree.map(np.asarray, tr.state.params),
                 np.array(jax.random.key_data(tr.state.rng))
                 if jnp.issubdtype(tr.state.rng.dtype, jax.dtypes.prng_key)
                 else np.array(tr.state.rng)))
            return tr

        mp.setattr(JR, f"{name}_trainer", make)
    mp.setattr(JRR, "RPNEnsemble", functools.partial(
        JRR.RPNEnsemble, compute_dtype=jnp.float32))
    orig_rpn = JRR.rpn_trainer

    def rpn(spec, stats, x, rng, ensemble_size, hidden):
        tr = orig_rpn(spec, stats, x, rng, ensemble_size=ensemble_size,
                      hidden=RPN_HIDDEN)
        built.setdefault("rpn", []).append(tuple(
            jax.tree.map(np.asarray, p) for p in (tr.params, tr.prior)))
        return tr

    mp.setattr(JRR, "rpn_trainer", rpn)


def _narrow_port(mp, built=None):
    """The port's recipes at the same narrow widths; with ``built``, at
    float32, each trainer loaded with the JAX trainer's weights."""
    mp.setattr("climsim_tpu_torch.models.EncoderDecoder", functools.partial(
        PMOD.EncoderDecoder, intermediate=ED_WIDTH))
    dt = {} if built is None else dict(compute_dtype=F32)
    for name, (kw, porter) in NARROW.items():
        orig = getattr(PR, f"{name}_trainer")

        def make(*a, _orig=orig, _kw=kw, _name=name, _porter=porter, **k):
            tr = _orig(*a, **{**k, **_kw, **dt})
            if built is not None:
                tr.model.load_state_dict(_porter(built[_name].pop(0)[0]))
            return tr

        mp.setattr(PR, f"{name}_trainer", make)
    orig_rpn = PRR.rpn_trainer

    def rpn(spec, stats, x, rng, ensemble_size, hidden=None, **k):
        tr = orig_rpn(spec, stats, x, rng, ensemble_size=ensemble_size,
                      hidden=RPN_HIDDEN, **k, **dt)
        if built is not None:
            tr.ensemble.load_state_dict(PM.port_flax_rpn(*built["rpn"].pop(0)))
        return tr

    mp.setattr(PRR, "rpn_trainer", rpn)


class _FeedRandn:
    """A module's ``torch`` with ``randn`` taking its draws from a queue
    (JAX's noise, in the order the port draws it)."""

    def __init__(self, queue):
        self.queue = queue

    def __getattr__(self, k):
        return getattr(torch, k)

    def randn(self, *shape, generator=None, device=None, dtype=None):
        a = torch.from_numpy(self.queue.pop(0))
        want = tuple(shape[0]) if len(shape) == 1 and isinstance(
            shape[0], (tuple, list, torch.Size)) else tuple(shape)
        assert tuple(a.shape) == want, (a.shape, want)
        return a.to(device=device, dtype=dtype or a.dtype)


def _feed_noise(mp, cvae_key, steps, batch, n_score):
    """The JAX draws the port makes otherwise: the cVAE's training eps
    (its state key split once a step), the HSR samples' eps of
    PRNGKey(9) and the cVAE samples' (z, eps) pairs of PRNGKey(9) split
    into 32."""
    key, train = jnp.asarray(cvae_key), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        train.append(np.array(jax.random.normal(
            sub, (batch, CVAE_LATENT), jnp.float32)))

    def normal(seed, shape, device):
        assert seed is not None   # train_and_score never evaluates
        return torch.from_numpy(train.pop(0))

    mp.setattr(PR, "_normal", normal)
    k9 = jax.random.PRNGKey(PRAB.SAMPLE_SEED)
    mp.setattr(PHSR, "torch", _FeedRandn([np.array(jax.random.normal(
        k9, (n_score, 128, NUM_SAMPLES), jnp.float32))]))
    pairs = []
    for r in jax.random.split(k9, NUM_SAMPLES):
        rz, ry = jax.random.split(r)
        pairs += [np.array(jax.random.normal(rz, (n_score, CVAE_LATENT))),
                  np.array(jax.random.normal(ry, (n_score, 128)))]
    mp.setattr(PCVAE, "torch", _FeedRandn(pairs))
    return train


@pytest.fixture(scope="module")
def figures(tmp_path_factory):
    """Each side's make_offline_figures.main and what its train_and_score
    and plotting functions were given and returned."""
    import climsim_tpu.eval.analysis as JA

    out = {}
    built = {}
    for side in ("jax", "port"):
        calls = {}
        with pytest.MonkeyPatch.context() as mp:
            if side == "jax":
                _narrow_jax(mp, built)
                mod, tas = JRAB, JRAB.train_and_score
                for name in ("plot_metric_bars", "plot_r2_maps"):
                    mp.setattr(JA, name, functools.partial(
                        _keep, calls, name, None))
            else:
                _narrow_port(mp, built)
                mod, tas = PRAB, PRAB.train_and_score
                n_score = DAYS * 12 * 384
                steps = EPOCHS * (48 * 384 // PRAB.BATCH)
                key = built["cvae"][0][1]
                left = _feed_noise(mp, key, steps, PRAB.BATCH, n_score)
                for name in ("plot_metric_bars", "plot_r2_maps"):
                    mp.setattr(PA, name, functools.partial(
                        _keep, calls, name, getattr(PA, name)))

            def keep_tas(*a, _side=side, **k):
                res = tas(*a, **k)
                calls["train_and_score"] = (a, k, res)
                # the port's figures from the JAX run's tables and
                # predictions: the plotted arrays then test the figure
                # path alone (train_and_score is held above)
                return out["jax"]["train_and_score"][2] if _side == "port" \
                    else res

            mp.setattr(mod, "train_and_score", keep_tas)
            if side == "jax":
                JMOF.main(epochs=EPOCHS, days=DAYS)
            else:
                outdir = tmp_path_factory.mktemp("figures")
                res = PMOF.main(["--epochs", str(EPOCHS), "--days",
                                 str(DAYS), "--outdir", str(outdir),
                                 "--device", "cpu"])
                calls["main"] = res
                assert not left   # every JAX eps was taken
        out[side] = calls
    assert not any(built.values())   # every JAX trainer was ported
    return out


def _keep(calls, name, draw, *a, **k):
    calls.setdefault(name, []).append((a, k))
    return None if draw is None else draw(*a, **k)


def _close(got, want, what, scaled=0.0, rtol=RTOL):
    """Within RTOL; ``scaled``: elementwise arrays (predictions, samples,
    maps), whose entries near 0 are held to scaled * max|want| instead."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=rtol,
        atol=scaled * np.abs(want).max(), err_msg=what)


def test_train_and_score_matches_jax(figures):
    """The same inputs; every table entry of the six models, the losses,
    the predictions and the samples (HSR and cVAE from JAX's noise, the
    RPN's posterior)."""
    ja, _, (jt, jinfo, jpreds, jsamples) = figures["jax"]["train_and_score"]
    pa, _, (pt, pinfo, ppreds, psamples) = figures["port"]["train_and_score"]
    for a, b in zip(ja, pa):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
    assert list(pt) == list(jt) == ["MLP", "ED", "CNN", "HSR", "cVAE", "RPN"]
    for m in jt:
        assert list(pt[m]) == list(jt[m])
        for v in jt[m]:
            assert set(pt[m][v]) == set(jt[m][v])
            for metric, want in jt[m][v].items():
                got = pt[m][v][metric]
                if metric == "bias":   # a signed mean: |bias| <= MAE
                    assert abs(got - want) <= TABLE_RTOL * jt[m][v][
                        "MAE"], f"{m} {v} bias"
                elif metric == "R2":   # 1 - sse / sst: sse's precision
                    _close(1 - got, 1 - want, f"{m} {v} 1 - R2",
                           rtol=TABLE_RTOL)
                else:
                    _close(got, want, f"{m} {v} {metric}", rtol=TABLE_RTOL)
        _close(pinfo[m]["loss"], jinfo[m]["loss"], f"{m} loss")
        assert np.isfinite(pinfo[m]["loss"])
        _close(ppreds[m], jpreds[m], f"{m} predictions", PRED_ATOL)
    assert set(psamples) == set(jsamples) == {"HSR", "cVAE", "RPN"}
    for m in jsamples:
        assert psamples[m].shape == jsamples[m].shape
        _close(psamples[m], jsamples[m], f"{m} samples", PRED_ATOL)
    # the CRPS column is there for the stochastic models only
    assert "CRPS" in pt["RPN"]["ptend_t"] and "CRPS" not in pt["MLP"][
        "ptend_t"]
    # steps and transform calls, the card's kernel-1 tally
    n_train = 48 * 384
    assert pinfo["MLP"]["steps"] == EPOCHS * (n_train // 1024)
    assert pinfo["CNN"]["steps"] == 3 * (n_train // 512)
    assert pinfo["HSR"]["transform_calls"] == 3 + 1   # 3 batches, 1 draw


def test_markdown_matches_the_script(figures):
    """The two markdown functions render the script's lines from the same
    tables (and BASELINE.md's reference columns)."""
    _, _, (tables, info, _, _) = figures["port"]["train_and_score"]
    ref = JRRB.parse_baseline_md(os.path.join(ROOT, "BASELINE.md"))
    assert PRAB.metric_tables_markdown(tables) == \
        JRAB.metric_tables_markdown(tables)
    assert PRAB.metric_tables_markdown(tables, reference=ref) == \
        JRAB.metric_tables_markdown(tables, reference=ref)
    assert PRAB.training_table_markdown(info) == \
        JRAB.training_table_markdown(info)


def test_offline_figures_plot_the_scripts_arrays(figures):
    """Given the JAX run's tables and predictions, the port's figure path
    hands plot_metric_bars and plot_r2_maps the script's arrays: the same
    tables, the R2 maps (lat, lev) a model and the pressure by latitude
    within FIG_RTOL (float64 host numpy on both sides); the port's four
    PNGs are written under its --outdir."""
    j, p = figures["jax"], figures["port"]
    assert [c[0][1] for c in p["plot_metric_bars"]] == \
        [c[0][1] for c in j["plot_metric_bars"]] == ["MAE", "R2"]
    for (pa, _), (ja, _) in zip(p["plot_metric_bars"], j["plot_metric_bars"]):
        assert pa[0] == ja[0]
    assert len(p["plot_r2_maps"]) == len(j["plot_r2_maps"]) == 2
    for (pa, _), (ja, _) in zip(p["plot_r2_maps"], j["plot_r2_maps"]):
        assert list(pa[0]) == list(ja[0])
        for m in ja[0]:
            assert pa[0][m].shape == ja[0][m].shape == (
                len(load_default_grid().unique_lats), 60)
            assert np.isfinite(pa[0][m]).all()
            np.testing.assert_allclose(pa[0][m], ja[0][m], rtol=FIG_RTOL,
                                       atol=0, err_msg=f"R2 map {m}")
        np.testing.assert_allclose(pa[2], ja[2], rtol=FIG_RTOL, atol=0)
    res = p["main"]
    assert [os.path.basename(f) for f in res["figures"]] == [
        "offline_mae_bars.torch.png", "offline_r2_bars.torch.png",
        "offline_r2_map_t.torch.png", "offline_r2_map_q.torch.png"]
    for f in res["figures"]:
        with open(f, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_offline_figures_without_matplotlib(monkeypatch, capsys):
    """Where matplotlib does not import, draw() draws nothing and says
    so; the arrays are computed all the same (host only)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert PMOF.draw({}, {}, None, None, "unused") == []
    spec, grid = get_varspec("v1"), load_default_grid()
    rng = np.random.default_rng(0)
    n = 2 * 12 * grid.ncol
    x = rng.standard_normal((n, spec.input_len)).astype(np.float32) + 1e5
    y = rng.standard_normal((n, spec.output_len)).astype(np.float32)
    from climsim_tpu_torch.norms import identity_norms

    maps, plat = PMOF.figure_arrays(spec, grid, identity_norms(spec), x, y,
                                    {"a": y, "b": 0.5 * y})
    assert np.allclose(maps["ptend_t"]["a"], 1.0)
    assert plat.shape == (len(grid.unique_lats), 60)


def test_parse_baseline_md_matches_the_script():
    path = os.path.join(ROOT, "BASELINE.md")
    got = PRRB.parse_baseline_md(path)
    assert got == JRRB.parse_baseline_md(path)
    assert got["ptend_t"]["MAE"] and PRRB.parse_baseline_md(
        os.path.join(ROOT, "absent.md")) == {}


def test_filelists_and_shards_match_the_script(tmp_path):
    """fallback_filelist and ingest_splits on a synthetic netCDF tree
    (tests/synthnc.py): the same files, shards byte-equal to the
    script's; a second call reuses the shards."""
    tree = tmp_path / "tree"
    make_tree(tree / "0001-02", jax_grid(), nsteps=16)
    for split in ("train", "scoring"):
        assert PRRB.fallback_filelist(str(tree), split) == \
            JRRB.fallback_filelist(str(tree), split)
    dirs = {s: tmp_path / s for s in ("port", "jax")}
    for d in dirs.values():
        d.mkdir()
    got = PRRB.ingest_splits(str(tree), str(dirs["port"]), get_varspec("v1"),
                             load_default_grid(), None, None, 0,
                             verbose=False)
    want = JRRB.ingest_splits(str(tree), str(dirs["jax"]), jax_varspec("v1"),
                              jax_grid(), None, None, 0, verbose=False)
    assert sorted(got) == sorted(want) == ["scoring", "train"]
    for split in got:
        for p, j in zip(got[split], want[split]):
            assert os.path.basename(p) == os.path.basename(j)
            with open(p, "rb") as a, open(j, "rb") as b:
                assert a.read() == b.read(), p
    assert PRRB.ingest_splits(str(tree), str(dirs["port"]), None, None, None,
                              None, 0, verbose=False) == got


def test_run_real_baselines_main(tmp_path, monkeypatch, capsys):
    """The entry end to end on a synthetic tree of 24 pairs of 384
    columns (the canonical train stride of 7 leaves 4 files, 1536 rows;
    the scoring split's fallback 2 files, 768 rows), narrow widths,
    --device cpu: a report with the reference columns, every table entry
    finite."""
    _narrow_port(monkeypatch)
    tree = tmp_path / "tree"
    make_tree(tree / "0001-02", jax_grid(), nsteps=24, ncol=384)
    out = tmp_path / "REAL.md"
    res = PRRB.main(["--data-dir", str(tree), "--shard-dir",
                        str(tmp_path / "shards"), "--epochs", "1",
                        "--workers", "0", "--out", str(out),
                        "--device", "cpu"])
    assert "train (1536, 124), scoring (768, 124)" in capsys.readouterr().out
    text = out.read_text()
    assert "| Variable | MLP | ED | CNN | HSR | cVAE | RPN | ref MLP |" in text
    assert "## Training" in text
    assert res["out"] == str(out) and set(res["train_info"]) == set(
        res["tables"])
    for m, t in res["tables"].items():
        for v, row in t.items():
            assert all(np.isfinite(x) for x in row.values()), (m, v)


def test_too_few_training_rows_are_refused():
    spec, grid = get_varspec("v1"), load_default_grid()
    x = np.zeros((1279, spec.input_len), np.float32)
    with pytest.raises(ValueError, match="at least 1280"):
        PRAB.train_and_score(spec, grid, None, x, x, x, x, device="cpu")


def test_run_all_baselines_main(tmp_path, monkeypatch):
    """main at narrow widths on the CPU writes its --out (never the JAX
    script's file) with the card line and the tables."""
    _narrow_port(monkeypatch)
    out = tmp_path / "SYN.md"
    res = PRAB.main(["--epochs", "1", "--n-train", "1280", "--n-score",
                     "384", "--out", str(out), "--device", "cpu"])
    text = out.read_text()
    assert "device: cpu" in text and "## MAE" in text and "## CRPS" in text
    assert set(res["train_info"]) == {"MLP", "ED", "CNN", "HSR", "cVAE",
                                      "RPN"}
    assert all(np.isfinite(i["loss"]) for i in res["train_info"].values())


@pytest.mark.parametrize("entry", ["run_all_baselines",
                                   "make_offline_figures",
                                   "run_real_baselines"])
def test_entries_default_to_the_card(entry, tmp_path):
    """Without --device each entry trains on the card: without one,
    torch's own error, before any report or figure is written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = {"run_all_baselines": ["--n-train", "1280", "--n-score", "384",
                                  "--out", str(tmp_path / "out.md")],
            "make_offline_figures": ["--n-train", "1280", "--days", "1",
                                     "--outdir", str(tmp_path / "out")],
            "run_real_baselines": ["--data-dir", str(tmp_path / "tree"),
                                   "--workers", "0",
                                   "--out", str(tmp_path / "out.md")]}[entry]
    if entry == "run_real_baselines":
        make_tree(tmp_path / "tree" / "0001-02", jax_grid(), nsteps=24,
                  ncol=384)
    mod = {"run_all_baselines": PRAB, "make_offline_figures": PMOF,
           "run_real_baselines": PRRB}[entry]
    with pytest.raises((AssertionError, RuntimeError)):
        mod.main(argv)
    assert not os.path.exists(tmp_path / "out.md")
    assert not os.path.exists(tmp_path / "out")

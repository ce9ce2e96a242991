"""Nothing the benchmark runs loads JAX or the JAX package, the
reference imports nothing of the port, and a run without a card exits
non-zero with no result."""

import ast
import os
import subprocess
import sys
import types

import pytest

from portbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert "climsim_tpu_torch" not in top_level_imports(path)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "climsim_tpu_torch_probe",
                        types.ModuleType("climsim_tpu_torch_probe"))
    monkeypatch.setitem(sys.modules, "jaxish", types.ModuleType("jaxish"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "climsim_tpu.probe",
                        types.ModuleType("climsim_tpu.probe"))
    assert harness.forbidden_loaded() == ["climsim_tpu.probe"]


def test_a_cpu_run_of_the_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.tests.conftest import tiny_cell, cpu_context\n"
            "from portbench import harness\n"
            "cell = tiny_cell('unet_v5.serve_c8')\n"
            "cell.driver.run(cpu_context(cell))\n"
            "print(harness.forbidden_loaded())" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_exits_nonzero_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "mlp_v1.train_b32768", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""

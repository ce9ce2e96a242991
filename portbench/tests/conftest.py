"""CPU tests of the benchmark's harness, and the card-marked tests run on
the card (``python -m pytest portbench/tests -m card``)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided here, when
    the test runs, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny_cell(name: str):
    """The cell ``name`` cut to a size the CPU runs in seconds: the U-Net
    at 16 channels and one block a level, batches of 64, 3 ranks of 16
    columns stepping together."""
    from portbench import harness

    cell = harness.Cell(name)
    if cell.spec["config"] == "unet_v5":
        cell.config["model"].update(model_channels=16, num_blocks=1)
    if cell.mix["driver"] == "train":
        cell.mix.update(batch=64, pool_batches=4, block_shuffle=8)
    else:
        cell.mix.update(clients=3, chunk=16, chunks_per_client=2,
                        base_chunk=16, max_batch=64, keep=2)
    return cell


def cpu_context(cell, seed: int = 2**31 + 7, seconds: float = 1.0):
    import time

    from portbench.run import Context

    return Context(cell, seed, seconds, False, device="cpu",
                   t_process=time.perf_counter())

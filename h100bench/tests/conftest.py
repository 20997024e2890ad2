"""The benchmark's own tests (`python -m pytest h100bench/tests -q`). They
run on the CPU; those marked `cuda` need an NVIDIA card and skip without
one, deciding in the `card` fixture, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the port's kernels")
    return torch.device("cuda")


def tiny(cell, nx=8, spp=4, depth=8, pixels=16):
    """The cell at a size the CPU renders in a second: the frame, the
    samples and the depth cut, the checks' sizes with them."""
    cell.config = dict(cell.config, nx=nx, ny=nx, spp=spp, max_depth=depth)
    cell.traffic = dict(cell.traffic, nx=nx, ny=nx, spp=max(1, spp // 2),
                        trace_items=2)
    cell.limits = dict(cell.limits, check_pixels=pixels,
                       check_paths=4 * pixels)
    return cell

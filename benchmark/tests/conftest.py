"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the repository root. Tests that need the card take the ``card`` fixture,
which skips without one."""

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the traced path reads the card's "
                    "kernels")
    return torch.device("cuda", 0)

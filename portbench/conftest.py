"""Fixtures of the benchmark's own tests."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test of the benchmark runs, as its command
    runs; the worker's setting comes back after it, for the tests that share
    the worker."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    from portbench.tiny import make_tiny

    return make_tiny(tmp_path_factory.mktemp("portbench"))

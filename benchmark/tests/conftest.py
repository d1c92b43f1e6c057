"""The benchmark's own tests: `python -m pytest benchmark/tests -q`.
Tests that need a CUDA card carry the `cuda` marker and skip without one
(decided inside a fixture, never at import)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402


def bench_json(kind: str, name: str) -> str:
    """The path of configuration or traffic `name` (kind "configs" or
    "traffic"): the benchmark's own, else a test shape in tests/data."""
    path = os.path.join(BENCH, kind, name + ".json")
    if os.path.exists(path):
        return path
    return os.path.join(BENCH, "tests", "data", name + ".json")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips with a reason where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")

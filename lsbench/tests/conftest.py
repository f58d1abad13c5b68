"""Shared set-up of the benchmark's CPU tests: the harness's root on the
path, one torch thread, and the tiny cells of ``data/bench.json`` (the
stage-2 layout at tiny widths under a two-client mix on a 160x120
avatar)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DATA = os.path.join(HERE, "data")
BENCH = os.path.join(DATA, "bench.json")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _switches_restored():
    """A run sets the configuration's switches in the environment."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("LATENTSYNC_")}
    yield
    for k in [k for k in os.environ if k.startswith("LATENTSYNC_")]:
        del os.environ[k]
    os.environ.update(saved)


@pytest.fixture
def tiny_run():
    """run(workload, seed, seconds=2, trace=False, faults=None) on the CPU."""
    from lsbench.run import run

    def go(workload, seed, seconds=2.0, trace=False, faults=None):
        return run(workload, seed, seconds, trace, device="cpu", bench_path=BENCH,
                   traffic_dir=DATA, faults=faults)

    return go


@pytest.fixture
def cuda_device():
    """The card, where there is one: the test skips elsewhere."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"

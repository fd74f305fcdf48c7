"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``gpu`` that skip themselves where there is no CUDA card (run them on the
card with ``python -m pytest -m gpu benchmark/tests``)."""

import pytest

TINY = dict(NMAX=16, NSTEPS=8, CROP_STEP=4, POINTNET_OUT_DIM=32,
            DTC_FILTERS=[8, 8, 8, 8, 8, 16], SUP_LATENT_DIM=8)
TINY_MIX = dict(crops=96, frames=[20, 30])


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips itself where there is none")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


def tiny_context(workload, seed, **hooks):
    """The cell's context at the CPU tests' small widths and split."""
    import torch

    from benchmark import harness

    torch.set_num_threads(2)
    ctx = harness.load_context(workload, seed, "cpu", dims=TINY, **hooks)
    ctx.traffic = dict(ctx.traffic, **TINY_MIX, batch=min(ctx.traffic["batch"], 32))
    return ctx

"""Serving at the tiny configuration on the CPU: the port's plain path
agrees with the reference, the control (the reference one precision step
down) and faults planted in the timed path fail the cells' limits."""
import pytest
import torch

from portbench import faults
from portbench.drivers import serve

from .common import serve_ctx, verdict

CELLS = ("flagship-serve-b1", "flagship-offline-b4")


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    torch.set_num_threads(2)
    return serve.run(serve_ctx(batch=2, control=True))


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_and_control_fails(cell, served):
    out = served
    r = out["readings"]
    assert r["heads"] < 1e-6 and r["depth"] < 1e-6 and r["nms"] == 0
    assert r["det_box"] < 1e-4 and r["det_score"] < 1e-6
    assert verdict(r, cell)["correct"]
    assert not verdict(out["control"], cell)["correct"]
    assert out["attempted"] >= 2 and out["metrics"]["serve_frames_per_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.SERVE)
def test_fault_fails(cell, fault):
    with faults.planted(fault):
        out = serve.run(serve_ctx(batch=2))
    assert not verdict(out["readings"], cell)["correct"], out["readings"]

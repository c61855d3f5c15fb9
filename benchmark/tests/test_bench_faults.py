"""``correct`` comes out false when the timed path is wrong: a run with
each fault a cell can have planted under it (the look for a card skipped,
the rest of the run as it is), and the control (the reference one
precision below the configuration's, in the program's place) held to the
cell's limits."""

import pytest
import torch

from benchmark import calibrate, faults, harness
from benchmark.tests.conftest import workloads

CELL_FAULTS = [(w, f) for w in workloads()
               for f in (("unchanged_state", "half_batch", "flipped_update")
                         if ".train" in w
                         else ("altered_answer",))]


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_a_planted_fault_is_not_correct(tiny_root, workload, fault):
    with faults.FAULTS[fault]():
        out = harness.run(tiny_root, workload, 2 ** 31 + 5, 0.3, False,
                          device="cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", workloads())
def test_the_control_is_not_correct(tiny_root, workload):
    c = harness.cell(tiny_root, workload)
    got = calibrate.control_numbers(c, 2 ** 31 + 9, torch.device("cpu"),
                                    None)
    assert any(v > c.limits[k] for k, v in got.items()), got

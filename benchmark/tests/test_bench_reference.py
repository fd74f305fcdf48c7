"""The plain reference against the program's plain CPU path at small
widths: a V4 step and an OR-CED step (three steps each, from the same
weights, rows and noise) and the eval encoder, through the numbers the
benchmark compares; the reference imports nothing of the program."""

import pytest

from benchmark import calibrate
from benchmark.tests.conftest import tiny_context


@pytest.mark.parametrize("workload", ["pcaa_v4.train_b16", "orced.train_b16",
                                      "pcaa_v4.eval_b256"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_reference_matches_program(workload, seed):
    nums = calibrate.readings(tiny_context(workload, seed), "program", {})
    nums.pop("leaves", None)
    assert nums and all(v < 1e-4 for v in nums.values()), nums

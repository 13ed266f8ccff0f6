"""The control of the output check: the reference one precision step down
(TF32 matmuls, which exist only on the card, and a bfloat16 state) in the
program's place must come out not correct, while the program is correct.
At the reduced sizes on the CPU; ``dspbench.control`` reads the full sizes
on the card."""

import pytest
import torch

from dspbench import check, harness
from dspbench.tests.small import small_cell

torch.set_num_threads(2)


@pytest.mark.parametrize("workload", ["vkitti2.drive", "zed2.walk"])
def test_the_control_fails_a_number(workload):
    cell = small_cell(workload)
    out = harness.run_cell(cell, 2**31 + 7, 0.5, False, device="cpu", control=True)
    assert out["correct"] is True, out["checks"]
    control = out["control_checks"]
    assert not check.verdict(control, cell.limits), control

"""On the card, at each cell's own size and on one seed: the program's
readings stay within the cell's limits, and the control (the plain
reference one precision below the configuration's, put in the program's
place) fails at least one of them. ``calibrate.py`` reads the same numbers
over a dozen seeds and three to set the limits."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

CELLS = ["stark16k.fp32", "stark16k.bf16", "phi4mini.train.b2s1024", "phi4mini.train.s2048acc8"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_program_within_and_control_outside_the_limits(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import calibrate
    from harness import spec

    cell = spec.cell(BENCH.parent, workload)
    dev, seed = torch.device("cuda"), 2**31 + 4099
    if cell.traffic["kind"] == "multiply":
        program = calibrate.multiply_readings(cell, seed, False, dev)
        control = calibrate.multiply_readings(cell, seed, True, dev)
    else:
        read = calibrate.train_readings(cell, seed, ("program", "control"), dev)
        program, control = read["program"], read["control"]
    lim = cell.limits
    assert all(program[n] <= lim[n] for n in lim), (program, lim)
    assert any(control[n] > lim[n] for n in lim), (control, lim)

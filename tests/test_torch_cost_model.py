"""Port parity: repro_torch.core.cost_model, a copy of repro.core.cost_model.

Every function gives ``==`` results to the reference for every (n, b) with
n = 2^p, 2^8 <= n <= 2^14 and b <= n / 2^4, and the cost-model tests of
``tests/test_strassen_core.py`` are mirrored on the copy.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np

from repro.core import cost_model as jc
from repro_torch.core import cost_model as tc
from repro_torch.core.cost_model import (
    CostModel,
    marlin_stages,
    mllib_stages,
    paper_stage_count,
    stark_stages,
    total_cost,
)

GRID = [(2**p, 2**q) for p in range(8, 15) for q in range(0, p - 3)]
SYSTEMS = ("stark", "marlin", "mllib")


def test_grid_covers_the_stated_range():
    assert min(n for n, _ in GRID) == 2**8 and max(n for n, _ in GRID) == 2**14
    assert all(b <= n // 2**4 for n, b in GRID) and (2**14, 2**10) in GRID


@pytest.mark.parametrize("system", SYSTEMS)
def test_stages_equal_reference(system):
    for n, b in GRID:
        got = getattr(tc, f"{system}_stages")(n, b)
        want = getattr(jc, f"{system}_stages")(n, b)
        assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
        assert tc.stage_count(system, n, b) == jc.stage_count(system, n, b)


@pytest.mark.parametrize("system", SYSTEMS)
def test_costs_equal_reference(system):
    models = [(tc.CostModel(), jc.CostModel()), (tc.CostModel(3e-12, 7e-10), jc.CostModel(3e-12, 7e-10))]
    for n, b in GRID:
        for cores in (1, 25, 1024):
            for tm, jm in models:
                for overlap in (False, True):
                    assert tc.total_cost(system, n, b, cores, tm, overlap=overlap) == jc.total_cost(
                        system, n, b, cores, jm, overlap=overlap)
                    stages_t = getattr(tc, f"{system}_stages")(n, b)
                    stages_j = getattr(jc, f"{system}_stages")(n, b)
                    assert tm.by_section(stages_t, cores, overlap=overlap) == jm.by_section(
                        stages_j, cores, overlap=overlap)
                    assert [s.wall_clock(cores, tm.t_flop, tm.t_elem, overlap=overlap)
                            for s in stages_t] == [
                        s.wall_clock(cores, jm.t_flop, jm.t_elem, overlap=overlap) for s in stages_j]
        assert tc.paper_stage_count(n, b) == jc.paper_stage_count(n, b)


def test_bad_sizes_raise_like_reference():
    for n, b in ((1000, 4), (1024, 3), (16, 32), (1024, 0)):
        with pytest.raises(ValueError, match="powers of two"):
            tc.stark_stages(n, b)
        with pytest.raises(ValueError, match="powers of two"):
            jc.stark_stages(n, b)


# ----------------------- tests/test_strassen_core.py cost-model tests, mirrored
def test_paper_stage_count_eq25():
    assert paper_stage_count(2**14, 2**4) == 2 * 4 + 2  # p=14, q=10
    assert paper_stage_count(4096, 2) == 2 * 1 + 2


def test_cost_model_orders_systems_like_paper():
    """Paper Fig. 8: Stark < Marlin <= MLLib at large sizes, any b."""
    for b in (8, 16, 32):
        stark = total_cost("stark", 16384, b, cores=25)
        marlin = total_cost("marlin", 16384, b, cores=25)
        mllib = total_cost("mllib", 16384, b, cores=25)
        assert stark < marlin and stark < mllib, (b, stark, marlin, mllib)


def test_cost_model_u_curve():
    """Paper Fig. 9: running time vs partition count is U-shaped."""
    costs = [total_cost("stark", 8192, b, cores=25) for b in (2, 4, 8, 16, 32, 64)]
    mins = int(np.argmin(costs))
    assert 0 < mins < len(costs) - 1, costs  # interior minimum


def test_cost_model_leaf_dominates_small_b():
    """Paper §V-E: leaf multiplication dominates at small partition counts."""
    model = CostModel()
    sections = model.by_section(stark_stages(8192, 4), cores=25)
    assert sections["leaf"] > sections["divide"]
    assert sections["leaf"] > sections["combine"]


def test_cost_model_overlap_prices_stages_at_max_not_sum():
    """overlap=True prices each stage at max(comp, comm) instead of comp + comm."""
    model = CostModel()
    stages = stark_stages(8192, 16)
    seq = model.total(stages, cores=25)
    ovl = model.total(stages, cores=25, overlap=True)
    assert ovl < seq
    for s in stages:
        both = s.wall_clock(25, model.t_flop, model.t_elem)
        hid = s.wall_clock(25, model.t_flop, model.t_elem, overlap=True)
        assert hid <= both
        pf = max(min(s.parallelization, 25), 1.0)
        assert hid == pytest.approx(
            max(s.computation * model.t_flop, s.communication * model.t_elem) / pf
        )
    sec_seq = model.by_section(stages, cores=25)
    sec_ovl = model.by_section(stages, cores=25, overlap=True)
    assert set(sec_ovl) == set(sec_seq)
    assert sum(sec_ovl.values()) == pytest.approx(ovl)
    assert all(sec_ovl[k] <= sec_seq[k] for k in sec_seq)


def test_cost_model_stark_fewer_leaf_flops():
    """Stark does b^2.807 leaf multiplies vs b^3 (the paper's core claim)."""
    n, b = 8192, 16
    stark_leaf = sum(s.computation for s in stark_stages(n, b) if s.section == "leaf")
    marlin_leaf = sum(s.computation for s in marlin_stages(n, b) if s.section == "leaf")
    mllib_leaf = sum(s.computation for s in mllib_stages(n, b) if s.section == "leaf")
    assert stark_leaf < marlin_leaf == mllib_leaf
    np.testing.assert_allclose(stark_leaf / marlin_leaf, 7**4 / 16**3, rtol=1e-6)

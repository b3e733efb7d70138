"""Port parity: repro_torch.blocks.tags and .plan against repro.blocks.

The two modules are copies on the port's coefficient tables, so on the CPU
every answer must be the reference's exactly: the tag codec over whole
ranges of indices, every registered plan's divide and combine tables
(``np.array_equal``), the tag algebra's term streams, and the dataflow
plans' programs step by step. The numpy schema helpers give the same bits.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.blocks import plan as jplan
from repro.blocks import tags as jtags
from repro_torch.blocks import plan as tplan
from repro_torch.blocks import tags as ttags
from repro_torch.core.coefficients import get_scheme, leaf_index_from_path, leaf_tag_path

SCHEMES = ["strassen", "winograd", "naive8"]


@pytest.mark.parametrize("base,depth", [(7, 1), (7, 2), (7, 3), (8, 2), (4, 1), (4, 2), (4, 4)])
def test_codec_equals_reference_over_ranges(base, depth):
    for index in range(base**depth):
        path = ttags.decode(index, depth, base)
        assert path == jtags.decode(index, depth, base)
        assert ttags.encode(path, base) == jtags.encode(path, base) == index
        s = ttags.to_string(path)
        assert s == jtags.to_string(path)
        assert ttags.from_string(s) == jtags.from_string(s) == path
        if base == 7:
            assert path == leaf_tag_path(index, depth)
            assert leaf_index_from_path(path) == index
    assert list(ttags.leaf_paths(depth, base)) == list(jtags.leaf_paths(depth, base))


def test_codec_errors_match_reference():
    for fn in (lambda t: t.decode(7, 1, 6), lambda t: t.encode((7,), 7),
               lambda t: t.parent(()), lambda t: t.child((), 9)):
        with pytest.raises(ValueError):
            fn(ttags)
        with pytest.raises(ValueError):
            fn(jtags)
    assert ttags.child(ttags.child((), 3), 0) == (3, 0) and ttags.parent((3, 0)) == (3,)
    assert (ttags.M_BASE, ttags.Q_BASE) == (jtags.M_BASE, jtags.Q_BASE)


@pytest.mark.parametrize("scheme_name", SCHEMES)
def test_tag_algebra_validates(scheme_name):
    ttags.validate_algebra(scheme_name, 1)
    ttags.validate_algebra(scheme_name, 2)


@pytest.mark.parametrize("scheme_name", SCHEMES)
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_operand_and_combine_terms_equal_reference(scheme_name, depth):
    rank = get_scheme(scheme_name).n_mults
    for path in ttags.leaf_paths(depth, rank):
        for side in ("a", "b"):
            assert (ttags.operand_terms(path, scheme_name, side)
                    == jtags.operand_terms(path, scheme_name, side))
        assert ttags.combine_terms(path, scheme_name) == jtags.combine_terms(path, scheme_name)
    with pytest.raises(ValueError):
        ttags.operand_terms((0,), scheme_name, "c")


def test_registry_equals_reference():
    assert tplan.plan_names() == jplan.plan_names()
    with pytest.raises(ValueError, match="unknown recursive plan"):
        tplan.get_plan("lu")


@pytest.mark.parametrize("name", ["strassen", "winograd", "naive8"])
def test_bilinear_plan_tables_equal_reference(name):
    got, want = tplan.get_plan(name), jplan.get_plan(name)
    assert isinstance(got, tplan.BilinearPlan)
    for field in ("name", "op", "operands", "result", "leaf_kind", "rank"):
        assert getattr(got, field) == getattr(want, field), field
    assert sorted(got.divide_coef) == sorted(want.divide_coef)
    for op in got.divide_coef:
        assert np.array_equal(got.divide_coef[op], want.divide_coef[op])
        assert got.divide_coef[op].dtype == want.divide_coef[op].dtype
    assert np.array_equal(got.combine_coef, want.combine_coef)
    # The plan's tables are its scheme's arrays, shared, not copied.
    assert got.divide_coef["A"] is got.scheme.a_coef and got.combine_coef is got.scheme.c_coef
    assert tplan.as_bilinear_plan(name) is got
    assert tplan.as_bilinear_plan(get_scheme(name)).name == name


@pytest.mark.parametrize("name", ["spin_inverse", "spin_trsm_lower", "spin_trsm_upper"])
def test_dataflow_plans_equal_reference_step_by_step(name):
    got, want = tplan.get_plan(name), jplan.get_plan(name)
    assert isinstance(got, tplan.DataflowPlan)
    for field in ("name", "op", "operands", "result", "leaf_kind", "divide", "combine",
                  "recursions"):
        assert getattr(got, field) == getattr(want, field), field
    assert len(got.program) == len(want.program)
    for g, w in zip(got.program, want.program):
        assert (g.kind, g.out, g.args, g.terms, g.alpha, g.plan) == (
            w.kind, w.out, w.args, w.terms, w.alpha, w.plan)
    with pytest.raises(ValueError, match="not wave-schedulable"):
        tplan.as_bilinear_plan(name)


def test_validation_errors_match_reference():
    s = get_scheme("strassen")
    bad = tplan.BilinearPlan(name="bad", op="matmul", operands=("A", "B"), result="C",
                             leaf_kind="matmul", scheme=s, divide_coef={"A": s.a_coef},
                             combine_coef=s.c_coef)
    with pytest.raises(ValueError, match="divide_coef keys"):
        bad.validate()
    undefined = tplan.DataflowPlan(name="u", op="inverse", operands=("A",), result="X",
                                   leaf_kind="inv", divide=(("A11", ("A", "q0")),),
                                   program=(tplan.Step("matmul", out="T", args=("A11", "Z")),))
    with pytest.raises(ValueError, match="undefined"):
        undefined.validate()
    with pytest.raises(ValueError, match="outside rank"):
        tplan.get_plan("strassen").combine_terms((7,))


@pytest.mark.parametrize("scheme_name", SCHEMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_schema_helpers_give_the_reference_bits(scheme_name, seed):
    s = get_scheme(scheme_name)
    x = np.random.default_rng(seed).standard_normal((16, 12)).astype(np.float32)
    got = tplan.apply_divide_schema(x, s.a_coef)
    want = jplan.apply_divide_schema(x, s.a_coef)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    assert (tplan.apply_combine_schema(got, s.c_coef).tobytes()
            == jplan.apply_combine_schema(want, s.c_coef).tobytes())
    for sel in ("q0", "q1", "q2", "q3", "r0", "r1"):
        assert np.array_equal(tplan.select_part(x, sel), jplan.select_part(x, sel))
    assert tplan.expand_terms((2, 5), s.b_coef) == jplan.expand_terms((2, 5), s.b_coef)

"""repro_torch.convert: operands and backend settings cross between the packages."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import ml_dtypes
import numpy as np

from repro.core import backend as jb
from repro_torch import convert
from repro_torch.core import backend as tb


def test_bf16_round_trips_bit_exactly():
    x = np.random.default_rng(0).standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    bits = x.view(np.uint16).copy()
    bits[0, :4] = [0x7F80, 0xFF80, 0x7FC1, 0x0001]  # +inf, -inf, a NaN payload, a subnormal
    x = bits.view(ml_dtypes.bfloat16)
    t = convert.tensor_from_numpy(x, "cpu")
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (5, 7)
    back = convert.tensor_to_numpy(t)
    assert back.dtype == x.dtype
    np.testing.assert_array_equal(back.view(np.uint16), bits)
    finite = np.isfinite(x.astype(np.float32))
    np.testing.assert_array_equal(t.float().numpy()[finite], x.astype(np.float32)[finite])


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_other_dtypes_round_trip(dtype):
    x = (np.arange(24).reshape(4, 6) * 1.5).astype(dtype)[:, ::2]  # not contiguous
    t = convert.tensor_from_numpy(x, torch.device("cpu"))
    np.testing.assert_array_equal(convert.tensor_to_numpy(t), x)


@pytest.mark.parametrize(
    "fields",
    [
        dict(),
        dict(kind="strassen_fused", depth=2, min_dim=512, precision="high"),
        dict(kind="auto", depth=3, tuning_cache="t.json", measure=True,
             schemes=("winograd",), device_budget=1 << 30, latency_hiding=True),
        dict(kind="strassen_oot", schemes=()),
    ],
)
def test_backend_from_fields_round_trips(fields):
    want = jb.MatmulBackend(**fields)
    d = dataclasses.asdict(want)
    got = convert.backend_from_fields(d)
    assert isinstance(got, tb.MatmulBackend)
    assert dataclasses.asdict(got) == d
    listed = convert.backend_from_fields({**d, "schemes": list(d["schemes"])})
    assert listed == got and isinstance(listed.schemes, tuple)


def test_backend_from_fields_rejects_unknown_kind_and_field():
    with pytest.raises(ValueError, match="unknown matmul backend kind"):
        convert.backend_from_fields({"kind": "fast"})
    with pytest.raises(TypeError):
        convert.backend_from_fields({"kind": "naive", "blocks": 4})

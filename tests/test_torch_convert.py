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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", [
    dict(),  # one layer per scan group: every layer in "groups"
    dict(n_layers=3, block_pattern=("attn", "attn")),  # a group of two, then a "tail" layer
    dict(n_layers=5, block_pattern=("attn",) * 4),  # phi4's period of four, plus a tail
])
def test_params_from_jax_is_bit_exact(layout, dtype):
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as TM

    jcfg = jax_smoke("phi4_mini_3_8b", dtype=dtype, **layout)
    tcfg = get_smoke_config("phi4_mini_3_8b", dtype=dtype, **layout)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    sd = convert.params_from_jax(jp, tcfg, "cpu")
    model = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    period, n_groups = len(jcfg.block_pattern), jcfg.n_layers // len(jcfg.block_pattern)
    for i in range(tcfg.n_layers):
        g, j = divmod(i, period)
        want = (jp["groups"][f"pos{j}"]["mixer"]["wq"]["w"][g] if g < n_groups
                else jp["tail"][i - n_groups * period]["mixer"]["wq"]["w"])
        got = convert.tensor_to_numpy(model.layers[i].mixer.wq.w)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), np.ascontiguousarray(want).view(np.uint8))
    np.testing.assert_array_equal(convert.tensor_to_numpy(sd["embed.embedding"]).view(np.uint8),
                                  jp["embed"]["embedding"].view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_is_bit_exact_for_xlstm(dtype):
    """xlstm's tree: sLSTM's bare ``r`` (4, H, dh, dh) fp32, its stacked ``w``
    (D, 4, H, dh) with bias, and mLSTM's fp32 gate projections with bias."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as TM

    jcfg = jax_smoke("xlstm_1_3b", dtype=dtype)
    tcfg = get_smoke_config("xlstm_1_3b", dtype=dtype)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jp["groups"]["pos3"]["mixer"]["w"]["b"] = np.ones_like(jp["groups"]["pos3"]["mixer"]["w"]["b"])
    sd = convert.params_from_jax(jp, tcfg, "cpu")
    model = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)

    def same(got, want):
        got = convert.tensor_to_numpy(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), np.ascontiguousarray(want).view(np.uint8))

    slstm, mlstm = jp["groups"]["pos3"]["mixer"], jp["groups"]["pos0"]["mixer"]
    assert slstm["r"].dtype == np.float32 and mlstm["wi"]["w"].dtype == np.float32
    same(model.layers[3].mixer.r, slstm["r"][0])
    same(model.layers[3].mixer.w.w, slstm["w"]["w"][0])
    same(model.layers[3].mixer.w.b, slstm["w"]["b"][0])
    for name in ("wi", "wf"):
        same(getattr(model.layers[0].mixer, name).w, mlstm[name]["w"][0])
        same(getattr(model.layers[0].mixer, name).b, mlstm[name]["b"][0])
    same(model.layers[0].mixer.wq.w, mlstm["wq"]["w"][0])

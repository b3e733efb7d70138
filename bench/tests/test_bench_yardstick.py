"""The yardstick's arithmetic against closed forms: the multiply's 2N^3, the
leaf's FLOPs and the levels' bytes for (N, depth, dtype), a decoder's 6NT
plus attention without recompute, AdamW's bytes, and the roofline's least
time."""
import pytest

from harness import cost, peaks

N = 16384
PHI4 = {"n_layers": 32, "d_model": 3072, "n_heads": 24, "n_kv_heads": 8, "head_dim": 128,
        "d_ff": 8192, "vocab": 200064, "glu": True, "tie_embeddings": True, "dtype": "bfloat16"}


def test_standard_multiply_is_2n3():
    assert cost.standard_multiply_flops(N, N, N) == 2 * N**3


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strassen_leaf(depth, dtype):
    leaf = cost.strassen_leaf(N, N, N, depth, "strassen", dtype)
    side = N // 2**depth
    assert leaf.ops == 2 * 7**depth * side**3
    assert leaf.bytes == 3 * 7**depth * side * side * cost.ITEMSIZE[dtype]


@pytest.mark.parametrize("dtype,size", [("float32", 4), ("bfloat16", 2)])
def test_strassen_level_bytes(dtype, size):
    # Level l reads 4 * 7^l quadrants and writes 7^(l+1) (a combine the
    # reverse), for A, B and C: 11 * 7^l planes of (N / 2^(l+1))^2 each.
    want = sum(3 * 11 * 7**lvl * (N // 2 ** (lvl + 1)) ** 2 * size for lvl in range(2))
    assert cost.strassen_level_bytes(N, N, N, 2, "strassen", dtype) == want
    assert want == (24_360_517_632 if size == 4 else 12_180_258_816)


def test_phi4_parameters():
    per_layer = 3072 * 3072 + 2 * 3072 * 1024 + 3072 * 3072 + 3 * 3072 * 8192 + 2 * 3072
    assert cost.dense_lm_params(PHI4) == 32 * per_layer + 200064 * 3072 + 3072 == 3_836_021_760


@pytest.mark.parametrize("batch,seq", [(1, 2048), (2, 1024), (8, 2048)])
def test_model_flops_are_6nt_plus_attention(batch, seq):
    pairs = seq * (seq + 1) // 2
    attn_fwd = 32 * 4 * batch * 24 * 128 * pairs
    want = 6 * 3_836_021_760 * batch * seq + 3.5 * attn_fwd
    assert cost.dense_lm_model_flops(PHI4, batch, seq) == pytest.approx(want, rel=1e-12)


def test_adamw_bytes():
    # read p (2), g (2), m (4), v (4); write p (2), m (4), v (4)
    assert cost.adamw_bytes(1000, "bfloat16", "float32") == 22_000
    assert cost.adamw_bytes(1000, "float32", "float32") == 28_000


def test_flash_counts():
    f = cost.flash(1, 24, 8, 2048, 2048, 128, True, None, "bfloat16", lse=True)
    assert f.ops == 4 * 24 * 128 * (2048 * 2049 // 2)
    assert f.bytes == (2 * 24 * 2048 * 128 + 2 * 8 * 2048 * 128) * 2 + 4 * 24 * 2048
    b = cost.flash_bwd(1, 24, 8, 2048, 2048, 128, True, None, "bfloat16")
    assert b.ops == 2.5 * f.ops
    assert cost.live_pairs(8, 8, True, 3) == 1 + 2 + 3 * 6


def test_least_seconds_takes_the_larger_bound():
    leaf = cost.strassen_leaf(N, N, N, 2, "strassen", "float32")
    assert peaks.least_seconds(leaf.ops, "float32", leaf.bytes) == leaf.ops / 67e12
    assert peaks.least_seconds(1.0, "bfloat16", 3.35e12) == 1.0

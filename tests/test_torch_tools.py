"""The port's tools that run on the card, checked here where they can be.

``tools/matmul_variants.py``, ``tools/slstm_variants.py``,
``tools/slstm_bwd_variants.py``, ``tools/rmsnorm_variants.py`` and
``tools/signed_sum_variants.py`` build design variants of the tiled matmul,
sLSTM forward and backward, RMSNorm and divide/combine kernels by replacing
lines of their ``csrc/*.cu``; each
replacement must still find its line in the shipped source, or the tool
stops on the card.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _tool(name="matmul_variants"):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_matmul_variant_applies_to_the_shipped_source():
    tool = _tool()
    shipped = (tool.CSRC / "matmul.cu").read_text()
    for name in tool.VARIANTS:
        text = tool.variant_source(name)
        assert text != shipped and "repro_batched_matmul" in text, name
    assert "wgmma_64x128x16" in tool.variant_source("bf16_tile_128x128")
    assert "setmaxnreg.dec" not in tool.variant_source("bf16_two_blocks")


def test_matmul_variants_refuses_without_a_gpu(monkeypatch):
    tool = _tool()
    monkeypatch.setattr(tool.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["matmul_variants.py"])
    assert tool.main() == 2


def test_every_slstm_variant_applies_and_refuses_without_a_gpu(monkeypatch):
    tool = _tool("slstm_variants")
    shipped = (tool.CSRC / "slstm.cu").read_text()
    for name in tool.VARIANTS:
        text = tool.variant_source(name)
        assert text != shipped and "repro_slstm_seq" in text, name
    assert "tile_dots<ROWS, true>" not in tool.variant_source("exchange_only")
    assert "wait_count(counters" not in tool.variant_source("no_wait")
    monkeypatch.setattr(tool.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["slstm_variants.py"])
    assert tool.main() == 2


def test_every_slstm_bwd_variant_applies_and_refuses_without_a_gpu(monkeypatch):
    tool = _tool("slstm_bwd_variants")
    shipped = (tool.CSRC / "slstm_bwd.cu").read_text()
    for name in tool.VARIANTS:
        text = tool.variant_source(name)
        assert text is not None and text != shipped and "repro_slstm_seq_bwd" in text, name
    assert tool.has_ring(shipped)
    assert "tile_dots_bwd<ROWS, true>" not in tool.variant_source("exchange_only")
    assert "spin_until(counters" not in tool.variant_source("no_wait")
    assert "for (int bb = 0; bb < nb; ++bb)" in tool.variant_source("serial_staging")
    assert '"n"(STAGERS)' not in tool.variant_source("block_staging")
    monkeypatch.setattr(tool.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["slstm_bwd_variants.py"])
    assert tool.main() == 2


def test_every_rmsnorm_variant_applies_and_refuses_without_a_gpu(monkeypatch):
    tool = _tool("rmsnorm_variants")
    shipped = (tool.CSRC / "rmsnorm.cu").read_text()
    for name in tool.VARIANTS:
        text = tool.variant_source(name)
        assert text != shipped and "repro_rmsnorm" in text, name
    assert "constexpr int MAXV = 16;" in tool.variant_source("warp_rows")
    monkeypatch.setattr(tool.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["rmsnorm_variants.py"])
    assert tool.main() == 2


def test_every_signed_sum_variant_applies_and_refuses_without_a_gpu(monkeypatch):
    tool = _tool("signed_sum_variants")
    shipped = (tool.CSRC / "signed_sum.cu").read_text()
    for name in tool.VARIANTS:
        text = tool.variant_source(name)
        assert text != shipped and "repro_signed_sum" in text, name
    assert "round_to<T>(__fadd_rn" not in tool.variant_source("round_once")
    assert "launch<__nv_bfloat16, 8>" in tool.variant_source("float_per_add")
    # round_once computes the fp32 sums of the terms rounded once: one bf16
    # ulp off the shipped (reference) rounding in some three-term sums
    x = torch.randn(1, 4, 16, 16).bfloat16()
    coef = tool.get_scheme("winograd").a_coef
    assert torch.equal(tool.expected("round_once", x.float(), coef), tool.expected("shipped", x.float(), coef))
    assert not torch.equal(tool.expected("round_once", x, coef), tool.expected("shipped", x, coef))
    monkeypatch.setattr(tool.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["signed_sum_variants.py"])
    assert tool.main() == 2

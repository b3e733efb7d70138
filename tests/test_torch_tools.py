"""The port's tools that run on the card, checked here where they can be.

``tools/matmul_variants.py`` builds design variants of the tiled matmul
kernel by replacing lines of ``csrc/matmul.cu``; each replacement must still
find its line in the shipped source, or the tool stops on the card.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

TOOL = Path(__file__).resolve().parents[1] / "tools" / "matmul_variants.py"


def _tool():
    spec = importlib.util.spec_from_file_location("matmul_variants", TOOL)
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

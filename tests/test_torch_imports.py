"""The port stands alone: no module of repro_torch, nor chip_smoke.py, imports
JAX or anything of the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_files_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {
        "__init__.py", "convert.py", "core/backend.py", "core/coefficients.py",
        "core/strassen.py", "kernels/_build.py", "kernels/common.py",
        "kernels/matmul/matmul.py", "kernels/strassen/strassen.py", "obs/tracer.py",
        "kernels/rmsnorm/rmsnorm.py", "kernels/rmsnorm/ref.py", "kernels/rmsnorm/ops.py",
        "kernels/flash_attention/flash_attention.py", "kernels/flash_attention/ref.py",
        "kernels/flash_attention/ops.py", "models/config.py", "models/rope.py",
        "models/layers.py", "models/attention.py", "models/mlp.py", "models/transformer.py",
        "models/model.py", "models/frontends.py", "configs/__init__.py",
        "configs/phi4_mini_3_8b.py", "serving/request.py", "serving/kv_pool.py",
        "serving/engine.py", "blocks/recovery.py", "launch/serve.py",
        "kernels/slstm/slstm.py", "kernels/slstm/ref.py", "kernels/slstm/ops.py",
        "models/xlstm.py", "configs/xlstm_1_3b.py",
        "core/cost_model.py", "core/autotune.py", "core/compat.py", "obs/export.py",
        "blocks/__init__.py", "blocks/tags.py", "blocks/plan.py", "blocks/blockmatrix.py",
        "blocks/scheduler.py", "blocks/solve.py", "launch/blocks_demo.py",
        "launch/solve_demo.py",
    } <= names
    csrc = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert {"rmsnorm.cu", "flash_attention.cu", "matmul.cu", "signed_sum.cu",
            "strassen1.cu", "slstm.cu"} <= csrc


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0 or path.parent.is_relative_to(PORT), path
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _banned(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.core.backend\n"
        "import repro_torch.kernels.strassen.ops, repro_torch.kernels.matmul.ops\n"
        "import repro_torch.obs\n"
        "import repro_torch.kernels.rmsnorm.ops, repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.slstm.ops, repro_torch.models.xlstm\n"
        "import repro_torch.configs, repro_torch.models.model, repro_torch.models.frontends\n"
        "import repro_torch.serving.engine, repro_torch.launch.serve\n"
        "import repro_torch.core.cost_model, repro_torch.core.autotune, repro_torch.core.compat\n"
        "import repro_torch.obs.export\n"
        "import repro_torch.blocks, repro_torch.launch.blocks_demo, repro_torch.launch.solve_demo\n"
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "[get_config(a) for a in ARCH_IDS]\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# The out-of-core path: what the card's machine runs for kind strassen_oot and
# the solvers. That machine has no ml_dtypes, so none of it may import it.
OOT_PATH = ["blocks/__init__.py", "blocks/tags.py", "blocks/plan.py", "blocks/blockmatrix.py",
            "blocks/recovery.py", "blocks/scheduler.py", "blocks/solve.py", "core/backend.py",
            "core/autotune.py", "launch/blocks_demo.py", "launch/solve_demo.py"]


@pytest.mark.parametrize("rel", OOT_PATH)
def test_oot_path_imports_no_ml_dtypes(rel):
    tree = ast.parse((PORT / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] == "ml_dtypes" for n in names), f"{rel}:{node.lineno}"
        # nor a module of the port that does (convert.py's test-side helper)
        assert not any(n == "repro_torch.convert" for n in names), f"{rel}:{node.lineno}"

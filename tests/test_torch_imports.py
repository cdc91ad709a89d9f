"""The port stands alone: it imports neither JAX nor the JAX package, and
importing it needs no CUDA, nvcc or Triton."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "mppi_tf_tpu_torch"


def _forbidden(name: str) -> bool:
    """True for jax / jaxlib and for mppi_tf_tpu (not mppi_tf_tpu_torch)."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "mppi_tf_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_leaves_no_jax_modules():
    code = (
        "import sys\n"
        "import mppi_tf_tpu_torch, mppi_tf_tpu_torch.controller, "
        "mppi_tf_tpu_torch.kernels.pm_mppi, mppi_tf_tpu_torch.kernels._build,"
        " mppi_tf_tpu_torch.envs, mppi_tf_tpu_torch.interop\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mppi_tf_tpu', 'triton'))\n"
        "print(','.join(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    # a directory with no nvcc: importing must not look for one
    env["PATH"] = os.path.dirname(sys.executable)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported: {out.stdout.strip()}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("mppi_tf_tpu.kernels")
    assert not _forbidden("mppi_tf_tpu_torch.kernels")
    assert not _forbidden("jaxtyping_like") and not _forbidden("torch")

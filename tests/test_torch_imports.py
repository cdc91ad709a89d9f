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
        " mppi_tf_tpu_torch.kernels.auv_mppi, mppi_tf_tpu_torch.models.auv,"
        " mppi_tf_tpu_torch.ops.quaternion, mppi_tf_tpu_torch.flagship,"
        " mppi_tf_tpu_torch.envs, mppi_tf_tpu_torch.interop,"
        " mppi_tf_tpu_torch.models.nn, mppi_tf_tpu_torch.kernels.nn_mppi,"
        " mppi_tf_tpu_torch.cfg, mppi_tf_tpu_torch.envs.runner,"
        " mppi_tf_tpu_torch.cli, mppi_tf_tpu_torch.costs.elipse,"
        " mppi_tf_tpu_torch.costs.waypoints,"
        " mppi_tf_tpu_torch.controller.missions,"
        " mppi_tf_tpu_torch.observer, mppi_tf_tpu_torch.observer.observer,"
        " mppi_tf_tpu_torch.learning, mppi_tf_tpu_torch.learning.replay,"
        " mppi_tf_tpu_torch.models.dmd, mppi_tf_tpu_torch.controller.dmd,"
        " mppi_tf_tpu_torch.learning.learner,"
        " mppi_tf_tpu_torch.learning.checkpoint,"
        " mppi_tf_tpu_torch.learning.datastore, mppi_tf_tpu_torch.collect,"
        " mppi_tf_tpu_torch.verify_models, mppi_tf_tpu_torch.envs.mjx_env,"
        " mppi_tf_tpu_torch.parallel, mppi_tf_tpu_torch.parallel.mesh,"
        " mppi_tf_tpu_torch.parallel.sharded,"
        " mppi_tf_tpu_torch.parallel.fused,"
        " mppi_tf_tpu_torch.parallel.launch,"
        " mppi_tf_tpu_torch.parallel.cluster,"
        " mppi_tf_tpu_torch.parallel._mp_worker,"
        " mppi_tf_tpu_torch.parallel.train, mppi_tf_tpu_torch.serve,"
        " mppi_tf_tpu_torch.sweep, mppi_tf_tpu_torch.roofline,"
        " mppi_tf_tpu_torch.native.core, mppi_tf_tpu_torch.envs.mujoco_env,"
        " mppi_tf_tpu_torch.utils.plotting\n"
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


#: the port's modules that may name each piece of the CUDA-graph
#: machinery: the graph module alone captures; it, the launch counts'
#: owners and the counters' report name the counts
_GRAPH_HOMES = {"controller/graph.py"}
_COUNT_HOMES = _GRAPH_HOMES | {"kernels/_launch.py", "kernels/plant.py",
                               "tracing.py"}


@pytest.mark.parametrize("name, homes", [
    ("torch.cuda.CUDAGraph", _GRAPH_HOMES),
    ("torch.cuda.graph(", _GRAPH_HOMES),
    ("captured_counts", _COUNT_HOMES),
    ("count_replays", _COUNT_HOMES)])
def test_cuda_graphs_have_one_home(name, homes):
    """Every CUDA graph of the port is captured, and its launches counted,
    through ``controller/graph.py``: no other module names the graph API
    or the capture and replay counts."""
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")
             if name in p.read_text()}
    assert names <= homes, sorted(names - homes)
    assert names & _GRAPH_HOMES


def test_sources_cover_the_auv_slice():
    names = {p.relative_to(REPO).as_posix() for p in _sources()}
    assert {"chip_smoke.py", "mppi_tf_tpu_torch/flagship.py",
            "mppi_tf_tpu_torch/ops/quaternion.py",
            "mppi_tf_tpu_torch/models/auv.py",
            "mppi_tf_tpu_torch/costs/static.py",
            "mppi_tf_tpu_torch/envs/analytic.py",
            "mppi_tf_tpu_torch/kernels/auv_mppi.py",
            "mppi_tf_tpu_torch/kernels/_launch.py"} <= names


def test_sources_cover_the_nn_slice():
    names = {p.relative_to(REPO).as_posix() for p in _sources()}
    assert {"mppi_tf_tpu_torch/models/nn.py",
            "mppi_tf_tpu_torch/kernels/nn_mppi.py",
            "mppi_tf_tpu_torch/cfg/config.py",
            "mppi_tf_tpu_torch/envs/runner.py",
            "mppi_tf_tpu_torch/cli.py"} <= names


def test_sources_cover_the_tracking_slice():
    names = {p.relative_to(REPO).as_posix() for p in _sources()}
    assert {"mppi_tf_tpu_torch/costs/elipse.py",
            "mppi_tf_tpu_torch/costs/waypoints.py",
            "mppi_tf_tpu_torch/controller/missions.py"} <= names


def test_sources_cover_the_observer():
    names = {p.relative_to(REPO).as_posix() for p in _sources()}
    assert {"mppi_tf_tpu_torch/observer/__init__.py",
            "mppi_tf_tpu_torch/observer/observer.py"} <= names


def test_sources_cover_the_dmd_slice():
    names = {p.relative_to(REPO).as_posix() for p in _sources()}
    assert {"mppi_tf_tpu_torch/learning/__init__.py",
            "mppi_tf_tpu_torch/learning/replay.py",
            "mppi_tf_tpu_torch/models/dmd.py",
            "mppi_tf_tpu_torch/controller/dmd.py"} <= names


def test_sources_cover_the_learner():
    names = {p.relative_to(REPO).as_posix() for p in _sources()}
    assert {"mppi_tf_tpu_torch/learning/learner.py",
            "mppi_tf_tpu_torch/learning/checkpoint.py",
            "mppi_tf_tpu_torch/learning/datastore.py",
            "mppi_tf_tpu_torch/collect.py",
            "mppi_tf_tpu_torch/verify_models.py"} <= names


def test_sources_cover_the_on_device_loop():
    names = {p.relative_to(REPO).as_posix() for p in _sources()}
    assert {"mppi_tf_tpu_torch/envs/mjx_env.py",
            "mppi_tf_tpu_torch/envs/__init__.py",
            "mppi_tf_tpu_torch/envs/runner.py"} <= names


def test_sources_cover_serving_and_tooling():
    names = {p.relative_to(REPO).as_posix() for p in _sources()}
    assert {"mppi_tf_tpu_torch/serve.py", "mppi_tf_tpu_torch/sweep.py",
            "mppi_tf_tpu_torch/roofline.py",
            "mppi_tf_tpu_torch/native/core.py",
            "mppi_tf_tpu_torch/envs/mujoco_env.py",
            "mppi_tf_tpu_torch/utils/plotting.py"} <= names


def test_native_core_is_the_ports_own_source():
    """The golden model builds the port's copy of the C++ source, in the
    port's build directory, and names no path of the JAX package."""
    text = (PORT / "native" / "core.py").read_text()
    assert "mppi_tf_tpu/native" not in text
    assert (PORT / "native" / "src" / "mppi_core.cpp").exists()


def test_no_refusal_names_a_roadmap_item():
    """Every module of the JAX package has its counterpart: no
    NotImplementedError of the port cites a ROADMAP item."""
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Raise) and node.exc is not None
                    and "NotImplementedError" in ast.unparse(node.exc)):
                assert "item" not in ast.unparse(node.exc), (
                    f"{path.name}:{node.lineno}")


def test_native_datastore_is_the_ports_own_source():
    """The datastore binding builds the port's copy of the C++ source, in
    the port's build directory, and names no path of the JAX package."""
    text = (PORT / "learning" / "datastore.py").read_text()
    assert "mppi_tf_tpu/native" not in text.replace(
        "mppi_tf_tpu/learning/datastore.py", "")
    assert (PORT / "native" / "src" / "datastore.cpp").exists()


def test_replay_buffer_imports_no_torch():
    """The replay buffer is host numpy, as in the JAX package: importing
    it alone loads no torch."""
    path = PORT / "learning" / "replay.py"
    store = PORT / "learning" / "datastore.py"
    code = ("import runpy, sys\n"
            f"ns = runpy.run_path({str(path)!r})\n"
            "ns['ReplayBuffer'](4, 2, 1).add([0, 1], [2], [3, 4])\n"
            f"ds = runpy.run_path({str(store)!r})\n"
            "ds['NativeDataStore'](4, 2, 1).add([0, 1], [2], [3, 4])\n"
            "print('torch' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_observer_imports_no_tensorboard():
    """Importing the observer needs no tensorboard package: it is imported
    when an observer is built, and the JSONL record stands without it."""
    code = ("import sys\n"
            "import mppi_tf_tpu_torch.observer\n"
            "print(any(m.startswith(('torch.utils.tensorboard', "
            "'tensorboard')) for m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("mppi_tf_tpu.kernels")
    assert not _forbidden("mppi_tf_tpu_torch.kernels")
    assert not _forbidden("jaxtyping_like") and not _forbidden("torch")

"""Multi-device and multi-process MPPI: the K samples sharded over a mesh
(``mesh.py``), the torch-route and fused-kernel sharded controllers
(``sharded.py``, ``fused.py``), process groups (``launch.py``), a local
multi-process cluster (``cluster.py``) and the dp x tp train step
(``train.py``). Counterpart of ``mppi_tf_tpu/parallel/``."""

# the controller package first: its sharded DMD classes import this
# package's controllers, which extend its MPPI
from .. import controller  # noqa: F401
from .mesh import Mesh, make_mesh, sample_axis
from .sharded import ShardedMPPI, build_sharded_solve

__all__ = ["Mesh", "make_mesh", "sample_axis", "ShardedMPPI",
           "build_sharded_solve", "ShardedFusedMPPI",
           "build_sharded_fused_solve", "launch"]


def __getattr__(name):
    import importlib

    if name in ("ShardedFusedMPPI", "build_sharded_fused_solve"):
        return getattr(importlib.import_module(".fused", __name__), name)
    if name == "launch":
        return importlib.import_module(".launch", __name__)
    raise AttributeError(name)

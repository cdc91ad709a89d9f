"""Multi-process execution of the port's sharded solves
(parallel/cluster.py, parallel/_mp_worker.py, parallel/launch.py).

Mirrors tests/test_multiprocess.py: a 2-process cluster on localhost,
each process driving 4 CPU shards, joined over gloo through a file store.
Its replicated results agree bit for bit across the workers, equal the
port's single-process 8-shard mesh bit for bit (every collective gathers
the shards' rows and reduces them in shard order) and match the JAX
package's 8-virtual-device solve. The workers also run the sharded fused
solve (its plain versions on the CPU) and a bench row.
"""

import numpy as np
import pytest
import torch

from mppi_tf_tpu_torch.parallel import make_mesh
from mppi_tf_tpu_torch.parallel._mp_worker import run_fused, run_mppi
from mppi_tf_tpu_torch.parallel.cluster import run_cluster

#: a small fused workload: the point mass with the static cost
SPEC = {"model": {"type": "point_mass", "mass": 1.0},
        "task": {"type": "static", "diag": True,
                 "goal": [1.0, 0.0, 0.5, 0.0, -0.5, 0.0],
                 "Q": [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]},
        "state_dim": 6, "action_dim": 3, "dt": 0.1, "gamma": 0.2,
        "env": {"samples": 1024, "horizon": 10, "lambda": 0.8,
                "upsilon": 1.0, "noise": np.diag([0.25] * 3).tolist(),
                "normalize": True},
        "z_seed": 0, "x0": [0.0] * 6, "prng_steps": 2}
#: every spawn's limit: a hung rank fails its test, not the suite
TIMEOUT = 240


@pytest.fixture(scope="module")
def cluster_results():
    return run_cluster(nproc=2, devices_per_proc=4, timeout=TIMEOUT,
                       device="cpu", workloads=("mppi", "fused", "fleet"),
                       spec=SPEC, bench="256,6,4")


def _single_process_jax():
    """The worker's workloads on the JAX package's 8 virtual devices
    (tests/test_multiprocess.py::_single_process_expected)."""
    from tests.test_multiprocess import _single_process_expected

    return _single_process_expected()


def test_two_process_cluster_runs(cluster_results):
    assert len(cluster_results) == 2
    for i, r in enumerate(cluster_results):
        assert r["pid"] == i and r["nproc"] == 2
        assert r["global_devices"] == 8 and r["backend"] == "gloo"


def test_workers_agree_bitexact(cluster_results):
    a, b = cluster_results
    for key in ("action", "useq", "norm_action", "norm_useq", "prng_action",
                "fused_action", "fused_useq", "fused_prng_actions"):
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


def test_multiprocess_equals_the_local_mesh(cluster_results):
    """2 processes x 4 shards == one process's 8-shard mesh, bit for bit:
    the gathers reduce in global shard order in either layout."""
    local = run_mppi(make_mesh(devices=["cpu"] * 8), torch.device("cpu"))
    for key in ("action", "useq", "norm_action", "norm_useq",
                "prng_action"):
        assert cluster_results[0][key] == local[key], key


def test_multiprocess_matches_jax_single_process(cluster_results):
    """The 2-process solve equals JAX's 1-process x 8-device solve on the
    same injected noise (f64)."""
    expected = _single_process_jax()
    got = cluster_results[0]
    for key in ("action", "useq", "norm_action", "norm_useq"):
        np.testing.assert_allclose(np.asarray(got[key]), expected[key],
                                   rtol=1e-12, atol=1e-12, err_msg=key)


def test_fused_across_ranks_equals_the_local_mesh(cluster_results):
    """The sharded fused solve over 2 ranks x 4 shards (its plain versions
    on the CPU) == a local mesh of 8 shards, bit for bit, on injected
    normals and on the Philox streams."""
    local = run_fused(make_mesh(devices=["cpu"] * 8), torch.device("cpu"),
                      SPEC)
    got = cluster_results[0]
    assert got["fused_class"] == "ShardedFusedMPPI"
    for key in ("fused_action", "fused_useq", "fused_prng_actions"):
        assert got[key] == local[key], key
    assert np.all(np.isfinite(got["fused_action"]))


def test_fleet_across_ranks_equals_the_unsharded_fleet(cluster_results):
    """FleetMPPI(mesh=) over 2 ranks x 4 shards: each rank solves its 4
    vehicles and the rows are exchanged; every rank returns all 8
    actions, the unsharded fleet's bits."""
    from mppi_tf_tpu_torch.parallel._mp_worker import run_fleet

    a, b = cluster_results
    assert a["fleet_actions"] == b["fleet_actions"]
    assert np.asarray(a["fleet_actions"]).shape == (3, 8, 2)
    assert a["fleet_actions"] == run_fleet(None, torch.device("cpu"))[
        "fleet_actions"]


def test_bench_row(cluster_results):
    for r in cluster_results:
        assert r["bench"] == {"K": 256, "TAU": 6, "CHAIN": 4}
        assert r["p50_solve_ms"] > 0 and r["p50_local_ms"] > 0


def test_a_failing_worker_fails_the_cluster():
    """A worker that raises stops the others (which would wait in a
    collective) and the call reports every worker's output."""
    bad = dict(SPEC, model={"type": "no_such_model"})
    with pytest.raises(RuntimeError, match="worker"):
        run_cluster(nproc=2, devices_per_proc=1, timeout=TIMEOUT,
                    device="cpu", workloads=("fused",), spec=bad)

"""Local multi-process cluster: spawn N worker processes that join one
``torch.distributed`` group and run the mesh-sharded solves, the proof
and timing surface of ``parallel/launch.py``.

Counterpart of ``mppi_tf_tpu/parallel/cluster.py``. The workers rendezvous
through a file store in the cluster's own directory (no port to race for
when clusters run side by side) and join over gloo: on the CPU, and on
one card, whose ranks share it (NCCL refuses two ranks on one GPU). Each
worker writes its results to a JSON file; its standard output and errors
are captured, never passed on. Every spawn has a timeout: a hung rank
fails the call instead of hanging it.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_PARALLEL_DIR = os.path.dirname(os.path.abspath(__file__))
# workers run ``python -m mppi_tf_tpu_torch.parallel._mp_worker``; the
# parent of the package this process imported goes first on their path,
# so a checkout runs without an install
_PKG_PARENT = os.path.dirname(os.path.dirname(_PARALLEL_DIR))


def run_cluster(nproc: int = 2, devices_per_proc: int = 4,
                timeout: int = 420, out_dir: str | None = None,
                bench: str = "", device: str = "cuda",
                workloads=("mppi",), spec: dict | None = None,
                train: dict | None = None, backend: str = "gloo") -> list:
    """Spawn ``nproc`` workers with ``devices_per_proc`` shards each (on
    ``device``: "cuda", ranks that share the card, or "cpu") and return
    their parsed result dicts, rank by rank. Raises ``RuntimeError``
    before spawning when ``device`` is "cuda" and no GPU is present.

    ``workloads`` (``_mp_worker``): "mppi", the JAX worker's three
    (injected noise, normalized, PRNG); "fused", ``ShardedFusedMPPI`` on
    the workload ``spec``; "group_loop", the solve and on-device loop of
    ``spec`` on a group whose collectives a graph captures (``backend``
    "nccl", one rank a GPU); "fleet", ``FleetMPPI(mesh=)`` over the ranks;
    "train", the dp x tp train step on ``train``
    (a dict of numpy arrays and settings, ``_mp_worker.run_train``).
    ``bench='K,TAU,CHAIN'`` also times a chained sharded solve a worker
    (``p50_solve_ms``, beside ``p50_local_ms`` of a local mesh with the
    same work a shard). ``out_dir`` defaults to a fresh temporary
    directory, removed afterwards. Raises ``RuntimeError`` with every
    worker's output when one fails or outlives ``timeout`` seconds.
    """
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_cluster(): no GPU is present; pass "
                           "device='cpu' for ranks of CPU shards")
    auto_dir = out_dir is None
    if auto_dir:
        out_dir = tempfile.mkdtemp(prefix="mppi_torch_cluster_")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "rendezvous")
    if os.path.exists(store):
        os.remove(store)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": _PKG_PARENT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    extra = []
    if spec is not None:
        path = os.path.join(out_dir, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        extra += ["--spec", path]
    if train is not None:
        import numpy as np

        path = os.path.join(out_dir, "train.npz")
        np.savez(path, **train)
        extra += ["--train", path]
    if bench:
        extra += ["--bench", bench]
    outs = [os.path.join(out_dir, f"mp_worker_{i}.json")
            for i in range(nproc)]
    logs = [os.path.join(out_dir, f"mp_worker_{i}.log")
            for i in range(nproc)]
    procs = []
    try:
        for i in range(nproc):
            if os.path.exists(outs[i]):
                os.remove(outs[i])
            cmd = [sys.executable, "-m",
                   "mppi_tf_tpu_torch.parallel._mp_worker",
                   "--init", f"file://{store}", "--nproc", str(nproc),
                   "--pid", str(i), "--out", outs[i],
                   "--shards", str(devices_per_proc), "--device", device,
                   "--workloads", ",".join(workloads),
                   "--backend", backend, *extra]
            with open(logs[i], "w") as log:
                procs.append(subprocess.Popen(
                    cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL))
        deadline = time.monotonic() + timeout
        # a worker that fails leaves the others waiting in a collective:
        # stop them all at the first failure or at the deadline
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failed = any(p.poll() not in (None, 0) for p in procs)
        timed_out = not failed and any(p.poll() is None for p in procs)
        if failed or timed_out:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            text = []
            for i, (p, path) in enumerate(zip(procs, logs)):
                with open(path) as f:
                    text.append(f"--- worker {i} (rc={p.returncode}) ---\n"
                                f"{f.read()}")
            why = f"timed out after {timeout} s" if timed_out else "failed"
            raise RuntimeError(f"cluster worker {why}:\n" + "\n".join(text))
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if auto_dir:
            shutil.rmtree(out_dir, ignore_errors=True)

"""Multi-process sharded mapping on the port: two gloo processes of 4 shards
each run the port's worker (`parallel/worker.py`: the sharded ESDF's halo
exchange across processes, then all-gathered submaps fused on every
process), held against each other and against the same 8 shards in one
process. The counterpart of the reference's tests/test_distributed.py."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.parallel.distributed import (
    make_global_spatial_mesh, put_sharded)

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(coordinator, n_proc, pid, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "isaac_ros_nvblox_tpu_torch.parallel.worker",
         coordinator, str(n_proc), str(pid), "--shards", "8", "--device",
         "cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(REPO))


def _value(out, key):
    return [line for line in out.splitlines() if key in line][0].split(key)[1]


def test_two_process_sharded_mapping():
    coordinator = f"127.0.0.1:{_free_port()}"
    workers = [_worker(coordinator, 2, pid) for pid in range(2)]
    workers.append(_worker("none", 1, 0, "--regions", "2"))
    outs = []
    try:
        for w in workers:
            outs.append(w.communicate(timeout=300)[0])
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
    for pid, w, out in zip((0, 1, 0), workers, outs):
        assert w.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"WORKER{pid} OK" in out
    # The sharded-ESDF checksum and the fused map's: equal on both
    # processes and to the single process holding all 8 shards.
    for key in ("resolved=", "fused="):
        vals = {_value(out, key).split()[0] for out in outs}
        assert len(vals) == 1, (key, vals)


def test_global_mesh_and_put_sharded_in_one_process():
    """Without a process group the global mesh is this process's shards;
    put_sharded hands each local shard its row of a replicated tree."""
    mesh = make_global_spatial_mesh(4, device="cpu")
    assert mesh.n_shards == 4 and mesh.local_shards == [0, 1, 2, 3]
    assert not mesh.multi_process
    tree = {"a": np.arange(8).reshape(4, 2), "b": [torch.ones(4, 3)]}
    out = put_sharded(tree, mesh)
    assert [t.tolist() for t in out["a"]] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert len(out["b"][0]) == 4 and out["b"][0][2].shape == (3,)

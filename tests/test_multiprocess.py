"""Multi-process `jax.distributed` execution (SURVEY.md §5.8; BASELINE
"N>=2 hosts"): two OS processes, each owning 4 virtual CPU devices, form
one 8-device mesh via jax.distributed.initialize and run the sharded
inverse-rendering step; loss must match the single-process 8-device run.

This exercises the REAL multi-host code path (coordinator handshake,
cross-process mesh, psum over the process boundary) that the virtual-mesh
dryrun cannot."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=pid)
assert jax.device_count() == 8, jax.device_count()
assert jax.local_device_count() == 4

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from __graft_entry__ import _cornell
from craytracer_tpu.parallel.sharded import RAY_AXIS, make_mesh, sharded_train_step

scene, camera, film = _cornell(16, 16)
mesh = make_mesh()
step = sharded_train_step(mesh, max_depth=2)

n = film.num_pixels
sharding = NamedSharding(mesh, P(RAY_AXIS))

def make_global(host_fn):
    # build a process-local shard of a globally-sharded array
    return jax.make_array_from_callback(
        (n,), sharding, lambda idx: host_fn()[idx])

ids_host = np.arange(n, dtype=np.int32)
tgt_host = np.zeros((n, 3), np.float32)
ids = jax.make_array_from_callback((n,), sharding, lambda idx: ids_host[idx])
tgt = jax.make_array_from_callback(
    (n, 3), NamedSharding(mesh, P(RAY_AXIS)), lambda idx: tgt_host[idx])

loss, grads = step(scene, camera, film, ids, 3, 0, tgt)
color_g = np.asarray(grads.materials.color)
print("RESULT", float(loss), float(np.abs(color_g).sum()), flush=True)
"""


@pytest.mark.skipif(os.environ.get("CI_NO_SUBPROCESS") == "1",
                    reason="subprocess spawning disabled")
def test_two_process_distributed_matches_single_process(tmp_path):
    port = _free_port()
    coord = f"localhost:{port}"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)

    repo = os.path.dirname(os.path.dirname(__file__))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo
    env.pop("JAX_NUM_PROCESSES", None)

    procs = [
        subprocess.Popen([sys.executable, str(worker), coord, str(i)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=env, cwd=os.path.dirname(os.path.dirname(__file__)))
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=480)
        assert p.returncode == 0, err.decode()[-2000:]
        outs.append(out.decode())

    results = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
        results.append([float(x) for x in line.split()[1:]])
    # both processes see the same psum-reduced loss and gradient
    np.testing.assert_allclose(results[0], results[1], rtol=1e-5)

    # compare against the single-process 8-virtual-device run
    single = _single_process_result()
    np.testing.assert_allclose(results[0], single, rtol=1e-4)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process_result():
    code = r"""
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from __graft_entry__ import _cornell
from craytracer_tpu.parallel.sharded import RAY_AXIS, make_mesh, sharded_train_step
scene, camera, film = _cornell(16, 16)
mesh = make_mesh()
step = sharded_train_step(mesh, max_depth=2)
n = film.num_pixels
ids = jnp.arange(n, dtype=jnp.int32)
tgt = jnp.zeros((n, 3), jnp.float32)
loss, grads = step(scene, camera, film, ids, 3, 0, tgt)
print("RESULT", float(loss), float(np.abs(np.asarray(grads.materials.color)).sum()), flush=True)
"""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         timeout=480, env=env,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    line = [ln for ln in out.stdout.decode().splitlines()
            if ln.startswith("RESULT")][0]
    return [float(x) for x in line.split()[1:]]

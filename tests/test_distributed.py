"""Multi-host bootstrap: jax.distributed entry point (SURVEY.md section 5.8).

`CGLB_DIST=auto` lets JAX discover the coordinator from a cluster scheduler.
Here the same hook is exercised with the explicit-addressing variant on TWO CPU PROCESSES: each worker initializes
via CGLB_COORDINATOR/CGLB_NUM_PROCESSES/CGLB_PROCESS_ID, builds the global
data_mesh, and runs a psum-reduced jitted computation over DCN-style
cross-process collectives.  Fresh subprocesses are required — the test
runner's own jax backend is already initialized single-process.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

_WORKER = r"""
import os, sys
import numpy as np

import jax
import jax.numpy as jnp

from cglb_tpu.parallel.mesh import (DATA_AXIS, data_mesh,
                                    maybe_initialize_distributed)
from jax.sharding import NamedSharding, PartitionSpec as P

assert maybe_initialize_distributed(), "env-gated init did not trigger"
assert jax.process_count() == 2, jax.process_count()
mesh = data_mesh()  # global mesh across both processes
assert mesh.devices.size == 2, mesh

# a jitted global computation: row-sharded x, psum-style reduction to a
# replicated scalar — the cross-process (DCN-analogue) collective path
sharding = NamedSharding(mesh, P(DATA_AXIS))
pid = jax.process_index()
local = np.arange(8.0)[pid * 4:(pid + 1) * 4]  # this process's row shard
xg = jax.make_array_from_process_local_data(sharding, local,
                                            global_shape=(8,))

@jax.jit
def total(v):
    return jnp.sum(v * v)

out = float(total(xg))
assert abs(out - float(np.sum(np.arange(8.0) ** 2))) < 1e-12, out
print(f"proc {jax.process_index()} ok", flush=True)
"""


@pytest.mark.skipif(os.environ.get("CGLB_SKIP_DIST_TEST") == "1",
                    reason="explicitly disabled")
def test_two_process_cpu_distributed(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    repo = str(Path(__file__).resolve().parent.parent)

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            # one local device per process; the global mesh has two
            XLA_FLAGS="--xla_force_host_platform_device_count=1",
            CGLB_COORDINATOR=f"localhost:{port}",
            CGLB_NUM_PROCESSES="2",
            CGLB_PROCESS_ID=str(pid),
            PYTHONPATH=repo,
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} ok" in out, out

"""Multi-host smoke test: two real OS processes form a jax.distributed
cluster over localhost (DCN analog), build one global mesh, and run a
psum-reduced computation — exercising parallel.mesh.init_multi_host,
which round 1 shipped as dead code (VERDICT item 9/SURVEY §5.8).
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    pid = int(sys.argv[1]); port = sys.argv[2]
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from orb_slam2_annotate_tpu.parallel.mesh import init_multi_host

    init_multi_host(coordinator=f"localhost:{port}", num_processes=2,
                    process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    devs = jax.devices()
    assert len(devs) == 4, devs          # 2 local x 2 processes
    mesh = Mesh(np.array(devs), ("mp",))

    @jax.jit
    def count(x):
        return jax.lax.psum(x, "mp")

    f = jax.shard_map(count, mesh=mesh, in_specs=P("mp"), out_specs=P())
    import jax.numpy as jnp
    x = jnp.ones((4,))
    out = f(x)
    assert float(out[0]) == 4.0, out
    print(f"MULTIHOST_OK p{pid} n_dev={len(devs)}")
""")


@pytest.mark.slow
def test_two_process_distributed_psum(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    # pick a free port
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-2000:]}"
        assert f"MULTIHOST_OK p{pid}" in out, out[-2000:]

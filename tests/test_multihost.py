"""Two-process ``jax.distributed`` smoke test on the CPU backend.

The only multi-process coverage in the tree: everything else tests
sharding on a single-process 8-device virtual mesh.  Here two real
processes (4 virtual CPU devices each) form a 2-host x 4-chip cluster
through ``parallel.multihost.initialize_multihost`` and render the same
scene through ``render_scene_sharded`` on a ``host_chip_mesh`` with a
model axis — exercising cross-process collectives (the hit-merge
all_gather rides the intra-host inner axis, pixel shards span the
inter-host outer axis) and the bit-identity contract across process boundaries.
"""

import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_render(tmp_path):
    port = _free_port()
    procs = []
    logs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)  # worker sets its own device count
        env.update(
            PYTHONPATH=REPO,
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
        )
        log = open(tmp_path / f"worker{pid}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_worker.py"),
             "gpu_spheres"],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(tmp_path),
        ))
    try:
        rcs = [p.wait(timeout=540) for p in procs]
    finally:
        for p in procs:
            p.poll() is None and p.kill()
        for log in logs:
            log.close()
    outputs = [
        (tmp_path / f"worker{i}.log").read_text() for i in range(2)
    ]
    assert rcs == [0, 0], f"worker logs:\n{outputs[0]}\n---\n{outputs[1]}"
    assert "process 0: OK" in outputs[0] + outputs[1]
    assert "process 1: OK" in outputs[0] + outputs[1]

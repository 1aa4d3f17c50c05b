"""Worker process for the multi-host smoke test (test_multihost.py).

Launched twice by the parent test with JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID set; each process owns 4 virtual CPU
devices, so the cluster presents a 2-host x 4-device topology — the CPU
stand-in for two multi-card hosts (intra-host inner axis, inter-host
outer axis).

Renders a scene through ``render_scene_sharded`` on a ``host_chip_mesh``
and checks the framework's sharding-invariance contract across PROCESS
boundaries: bit-identical to the local single-process render for pure
data parallelism, and float-equivalent (atol 2e-5, matching
``tests/test_parallel.py``) for the model-sharded compacted path, whose
ray permutations let XLA reassociate (R, 3) reductions per
shape/position.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import numpy as np  # noqa: E402


def main():
    import jax  # noqa: E402

    from raytracinginonesemester_tpu.parallel.multihost import (  # noqa: E402
        host_chip_mesh,
        initialize_multihost,
        is_multihost,
    )

    assert initialize_multihost(), "env vars must trigger initialization"
    assert is_multihost() and jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == 4, len(jax.local_devices())

    from jax.experimental import multihost_utils  # noqa: E402

    from raytracinginonesemester_tpu.parallel.sharded import (  # noqa: E402
        render_scene_sharded,
    )
    from raytracinginonesemester_tpu.render.renderer import render_scene  # noqa: E402
    from raytracinginonesemester_tpu.scene.build import load_scene  # noqa: E402

    scene_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "assets", "scenes", sys.argv[1] + ".json",
    )
    scene = load_scene(scene_path)

    local = np.asarray(render_scene(scene))

    # Pure DP over both hosts: the bit-identity contract (seeding by
    # absolute pixel keeps every lane's arithmetic identical).
    mesh_dp = host_chip_mesh(("data", "model"), model_parallel_per_host=1)
    assert mesh_dp.shape == {"data": 8, "model": 1}, mesh_dp.shape
    img = render_scene_sharded(scene, mesh_dp, model_axis="model")
    full = np.asarray(multihost_utils.process_allgather(img, tiled=True))
    np.testing.assert_array_equal(full, local)

    # model axis confined to one host's devices, data axis spanning
    # both hosts.  The compacted model-sharded
    # path permutes rays through XLA glue, which reassociates (R, 3)
    # reductions per shape/position — float-equivalent only.
    mesh = host_chip_mesh(("data", "model"), model_parallel_per_host=2)
    assert mesh.shape == {"data": 4, "model": 2}, mesh.shape
    img = render_scene_sharded(scene, mesh, model_axis="model")
    full = np.asarray(multihost_utils.process_allgather(img, tiled=True))
    np.testing.assert_allclose(full, local, atol=2e-5)
    # make both processes reach the barrier before exiting
    multihost_utils.sync_global_devices("render-compared")
    print(f"process {jax.process_index()}: OK", flush=True)


if __name__ == "__main__":
    main()

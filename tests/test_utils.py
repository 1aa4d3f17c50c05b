"""utils + multihost helper tests."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracinginonesemester_tpu.utils.logging import MetricsLogger, progress_bar
from raytracinginonesemester_tpu.utils.timing import (
    Timer,
    measure,
    rays_per_second,
)


def test_timer_and_sync():
    with Timer("t") as t:
        t.result = jnp.ones((64, 64)) * 2.0
    assert t.seconds >= 0.0


def test_measure():
    f = jax.jit(lambda x: jnp.sum(x * 2))
    stats = measure(f, jnp.ones(128), warmup=1, iters=3)
    assert stats["iters"] == 3
    assert stats["min_s"] <= stats["median_s"] <= stats["max_s"]


def test_rays_per_second():
    m = rays_per_second(1920, 1080, 2, 0.5, waves=4)
    assert m["camera_rays_per_s"] == pytest.approx(1920 * 1080 * 2 / 0.5)
    assert m["traced_rays_per_s_est"] == pytest.approx(1920 * 1080 * 2 * 4 / 0.5)


def test_metrics_logger(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path, echo=False)
    log.log("step", loss=0.5, i=3)
    log.log("done", loss=0.1)
    log.close()
    lines = [json.loads(l) for l in open(path)]
    assert lines[0]["event"] == "step" and lines[0]["loss"] == 0.5
    assert lines[1]["event"] == "done"


def test_progress_bar():
    s = progress_bar(20, 40, width=10)
    assert "50%" in s and s.count("=") == 5


def test_multihost_single_process():
    from raytracinginonesemester_tpu.parallel.multihost import (
        host_chip_mesh,
        initialize_multihost,
        is_multihost,
    )

    assert initialize_multihost() is False  # no coordinator env
    assert not is_multihost()
    mesh = host_chip_mesh(model_parallel_per_host=2)
    assert mesh.shape["data"] * mesh.shape["model"] == jax.device_count()
    assert mesh.shape["model"] == 2


def test_checkpoint_roundtrip(tmp_path):
    from raytracinginonesemester_tpu.diff.checkpoint import (
        latest_step,
        load_checkpoint,
        save_checkpoint,
    )

    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, {"a": jnp.arange(4.0)}, opt_state={"m": jnp.zeros(2)},
                    losses=[2.0, 1.0])
    save_checkpoint(d, 7, {"a": jnp.arange(4.0) * 2}, losses=[0.5])
    assert latest_step(d) == 7
    step, params, _, losses = load_checkpoint(d)
    assert step == 7 and losses == [0.5]
    np.testing.assert_allclose(np.asarray(params["a"]), [0, 2, 4, 6])


def test_subdivide_preserves_surface():
    """Midpoint subdivision (scene.subdivide): 4x count per level, the
    union of children covers exactly the parent surface (area sum and
    AABB preserved), children inherit the parent's obj id, and a
    closest-hit render through the subdivided geometry finds the same
    hit distances (same surface -> same t, up to fp reassociation)."""
    import numpy as np
    import jax.numpy as jnp

    from raytracinginonesemester_tpu.ops.intersect import intersect_closest
    from raytracinginonesemester_tpu.scene.subdivide import subdivide_tris

    rs = np.random.RandomState(3)
    v = rs.standard_normal((7, 3, 3)).astype(np.float32)
    n = rs.standard_normal((7, 3, 3)).astype(np.float32)
    o = np.arange(7, dtype=np.int32)
    sv, sn, so = subdivide_tris(v, n, o, levels=2)
    assert sv.shape == (7 * 16, 3, 3) and so.shape == (112,)
    np.testing.assert_array_equal(so, np.repeat(o, 16))

    def area(t):
        e1 = t[:, 1] - t[:, 0]
        e2 = t[:, 2] - t[:, 0]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)

    np.testing.assert_allclose(
        area(sv).reshape(7, 16).sum(1), area(v), rtol=1e-5)
    np.testing.assert_allclose(sv.reshape(7, -1, 3).min(1),
                               v.min(1), atol=1e-6)
    np.testing.assert_allclose(sv.reshape(7, -1, 3).max(1),
                               v.max(1), atol=1e-6)

    # same surface -> same closest-hit distances
    pad = lambda a: np.concatenate(
        [a, np.broadcast_to(a[0, 0], ((-len(a)) % 512, 3, 3))]).astype(
            np.float32)
    origins = jnp.asarray(rs.standard_normal((64, 3)).astype(np.float32) * 4)
    dirs = rs.standard_normal((64, 3)).astype(np.float32)
    dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
    h0 = intersect_closest(origins, dirs, jnp.asarray(pad(v)))
    h1 = intersect_closest(origins, dirs, jnp.asarray(pad(sv)))
    np.testing.assert_array_equal(np.asarray(h0.hit), np.asarray(h1.hit))
    np.testing.assert_allclose(
        np.where(np.asarray(h0.hit), np.asarray(h0.t), 0.0),
        np.where(np.asarray(h1.hit), np.asarray(h1.t), 0.0), rtol=2e-5)

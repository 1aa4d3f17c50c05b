"""Smoke test of the path tracer on one GPU.

Runs, in one process on one card:

1. device  — the card JAX sees (fails without a GPU), its name and power
   limit from ``nvidia-smi``;
2. kernels — each traversal kernel compiled at real widths (the 2,073,600
   frog camera rays of a 1080p frame, one bounce wavefront, one shadow
   wavefront) against the XLA block path on every ray and the brute-force
   intersector on a 65,536-ray subset;
3. golden  — every scene under ``tests/assets/scenes`` plus HW1 through
   the renderer, against ``tests/goldens``;
4. frame   — frog 1920x1080 spp 1 depth 8 through ``render_scene`` and
   ``render_scene_frames`` with each traversal implementation: images
   finite and alike, ms/frame for each;
5. train   — three Adam steps of the BASELINE config-4 inverse-rendering
   loss: finite loss that decreases, finite gradients.

With ``--devices 4`` it runs only the four-card phase instead:
``render_scene_sharded`` at dp=4 (bit for bit against one card) and at
dp x tp = 2 x 2, and one dp=4 train step against the one-card loss.

Prints one line per phase; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failure exits non-zero without that line.

Usage:  python chip_smoke.py [--devices 4]
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import raytracinginonesemester_tpu as rt  # noqa: E402
from raytracinginonesemester_tpu.io.image import quantize, read_png  # noqa: E402
from raytracinginonesemester_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

W, H = 1920, 1080
RAY_SUBSET = 65536
MIN_AGREE = 0.9999
T_RTOL = 1e-5


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    """``nvidia-smi`` name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def images_close(ours, golden, max_bad_frac=2e-3, max_mean=0.5):
    """The golden suite's bounds (``tests/conftest.assert_images_close``):
    at most 2e-3 of uint8 channels off by more than 1, mean diff <= 0.5."""
    diff = np.abs(ours.astype(np.int32) - golden.astype(np.int32))
    bad, mean = float((diff > 1).mean()), float(diff.mean())
    return bad <= max_bad_frac and mean <= max_mean, bad, mean


def timed(fn, iters=5):
    """Median ms of ``fn(i)`` after one warmup call."""
    jax.block_until_ready(fn(0))
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i + 1))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2] * 1e3


def frog(width=W, height=H, **kw):
    from __graft_entry__ import _frog_scene

    return _frog_scene(width=width, height=height, spp=1, max_bounces=8,
                       diffuse_bounce=True, **kw)


def memory(compiled) -> str:
    m = compiled.memory_analysis()
    return (f"temp={m.temp_size_in_bytes / 2**20:.1f}MiB "
            f"args={m.argument_size_in_bytes / 2**20:.1f}MiB "
            f"out={m.output_size_in_bytes / 2**20:.1f}MiB")


# --- phase 2: kernels ---

def wavefronts(scene):
    """Camera rays of the frame (tile-swizzled pixel order, in-frame
    pixels only), one diffuse-bounce wavefront from their hits (misses
    parked at 1e30) and one shadow wavefront toward the light."""
    from raytracinginonesemester_tpu.ops.accel import block_closest
    from raytracinginonesemester_tpu.ops.intersect import make_hit_frame
    from raytracinginonesemester_tpu.render.renderer import (
        DEFAULT_RAY_TILE, _swizzled_grid, _tile_map)

    xs, ys, _ = _swizzled_grid(W, H)
    keep = np.flatnonzero((np.asarray(xs) < W) & (np.asarray(ys) < H))
    xs, ys = xs[keep], ys[keep]
    o, d = scene.camera.get_rays(xs.astype(jnp.float32) + 0.5,
                                 ys.astype(jnp.float32) + 0.5)

    def xla_closest(args):
        oo, dd = args
        return block_closest(oo, dd, scene.accel, tmin=1e-4, det_eps=1e-8)

    hits = jax.jit(lambda o, d: _tile_map(
        xla_closest, (o, d), o.shape[0], DEFAULT_RAY_TILE))(o, d)
    p, n, _ = make_hit_frame(o, d, hits, scene.geometry.vertices,
                             scene.geometry.normals, mode="gpu")
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    bd = jax.random.normal(jax.random.PRNGKey(0), d.shape)
    bd = bd / jnp.linalg.norm(bd, axis=-1, keepdims=True)
    bd = jnp.where(jnp.sum(bd * n, -1, keepdims=True) < 0, -bd, bd)
    bo = jnp.where(hits.hit[:, None], p + 1e-3 * n, 1e30)
    light = scene.lights.position[0]
    to_l = light[None] - bo
    dist = jnp.linalg.norm(to_l, axis=-1)
    sd = to_l / dist[:, None]
    return (o, d), (bo, bd), (bo, sd, dist)


def agreement(kind, got, ref):
    """Share of rays whose hit flag and winner agree, and the worst
    relative t difference where winners match."""
    if kind == "occluded":
        return float(np.mean(np.asarray(got) == np.asarray(ref))), 0.0
    gi, ri = np.asarray(got.tri_idx), np.asarray(ref.tri_idx)
    same = (gi == ri)
    hit = same & (ri >= 0)
    gt, rt_ = np.asarray(got.t)[hit], np.asarray(ref.t)[hit]
    rel = float(np.max(np.abs(gt - rt_) / np.abs(rt_))) if hit.any() else 0.0
    return float(same.mean()), rel


def phase_kernels(scene):
    from raytracinginonesemester_tpu.ops.accel import (block_closest,
                                                       block_occluded)
    from raytracinginonesemester_tpu.ops.backend import resolve_traversal
    from raytracinginonesemester_tpu.ops.intersect import (intersect_closest,
                                                           occluded)
    from raytracinginonesemester_tpu.ops.pallas_kernels import (
        pallas_block_closest, pallas_block_occluded)
    from raytracinginonesemester_tpu.render.renderer import (
        DEFAULT_RAY_TILE, _tile_map)

    if resolve_traversal(None) == "xla":
        log("kernels", ok=True, note="no hand-written kernel on this path")
        return True
    cam, bounce, shadow = wavefronts(scene)
    grid, verts = scene.accel, scene.geometry.vertices
    sub = np.arange(0, cam[0].shape[0], 31)[:RAY_SUBSET]
    ok = True
    cases = [("closest", "camera", cam, None), ("closest", "bounce", bounce,
                                                None),
             ("occluded", "shadow", shadow[:2], shadow[2])]
    for kind, name, (o, d), tmax in cases:
        if kind == "closest":
            kern = jax.jit(lambda o, d: pallas_block_closest(
                o, d, grid, tmin=1e-4, det_eps=1e-8))
            args = (o, d)
            xla_one = lambda a: block_closest(a[0], a[1], grid, tmin=1e-4,
                                              det_eps=1e-8)
            brute = lambda o, d: intersect_closest(o, d, verts, tmin=1e-4,
                                                   det_eps=1e-8)
        else:
            kern = jax.jit(lambda o, d, t: pallas_block_occluded(
                o, d, grid, tmin=1e-4, tmax=t, det_eps=1e-8))
            args = (o, d, tmax)
            xla_one = lambda a: block_occluded(a[0], a[1], grid, tmin=1e-4,
                                               tmax=a[2], det_eps=1e-8)
            brute = lambda o, d, t: occluded(o, d, verts, tmin=1e-4, tmax=t,
                                             det_eps=1e-8)
        compiled = kern.lower(*args).compile()
        got = compiled(*args)
        ms = timed(lambda i: compiled(*args), iters=3)
        ref = jax.jit(lambda *a: _tile_map(
            xla_one, a, a[0].shape[0], DEFAULT_RAY_TILE))(*args)
        agree_x, rel_x = agreement(kind, got, ref)
        sargs = tuple(a[sub] for a in args)
        bref = jax.jit(brute)(*sargs)
        gsub = jax.tree.map(lambda a: a[sub], got)
        agree_b, rel_b = agreement(kind, gsub, bref)
        case_ok = (min(agree_x, agree_b) >= MIN_AGREE
                   and max(rel_x, rel_b) <= T_RTOL)
        ok &= case_ok
        log("kernels", kernel=f"{kind}/{name}", rays=o.shape[0],
            vs_xla_agree=f"{agree_x:.6f}", vs_xla_t_rel=f"{rel_x:.2e}",
            vs_brute_agree=f"{agree_b:.6f}", vs_brute_t_rel=f"{rel_b:.2e}",
            kernel_ms=f"{ms:.3f}", mem=memory(compiled).replace(" ", ","),
            ok=case_ok)
    return ok


# --- phase 3: golden ---

def phase_golden():
    from raytracinginonesemester_tpu.core.camera import Camera
    from raytracinginonesemester_tpu.io.obj import load_obj, mesh_to_triangles
    from raytracinginonesemester_tpu.render.renderer import render_hw1
    from raytracinginonesemester_tpu.scene.build import geometry_from_mesh

    ok = True
    scenes = os.path.join(REPO, "tests/assets/scenes")
    goldens = os.path.join(REPO, "tests/goldens")
    for fname in sorted(os.listdir(scenes)):
        name = fname[:-len(".json")]
        scene = rt.load_scene(os.path.join(scenes, fname))
        if scene.dialect == "gpu":
            img = rt.render_scene(scene, jitter_mode="reference_cpu")
        else:
            img = rt.render_scene(scene)
        ours = quantize(np.asarray(img), scene.dialect)
        good, bad, mean = images_close(
            ours, read_png(os.path.join(goldens, f"{name}.png")))
        ok &= good
        log("golden", scene=name, bad_frac=f"{bad:.5f}", mean=f"{mean:.4f}",
            ok=good)
    cam = Camera.create(position=(0.0, -1.0, 1.0), look_at=(0.0, 0.15, 0.0),
                        up=(0.0, 0.0, 1.0), focal_length_mm=255.0,
                        sensor_height_mm=24.0, width=320, height=180)
    for mesh_name in ("sphere", "frog"):
        mesh, _ = load_obj(os.path.join(REPO, "tests/assets/meshes",
                                        f"{mesh_name}.obj"))
        geom = geometry_from_mesh(*mesh_to_triangles(mesh))
        img = render_hw1(geom.vertices, geom.normals, cam,
                         jnp.asarray([-3.0, 0.0, 1.0]),
                         jnp.asarray([1.0, 0.0, 1.0]), 320, 180, spp=1)
        good, bad, mean = images_close(
            quantize(np.asarray(img), "hw1"),
            read_png(os.path.join(goldens, f"hw1_{mesh_name}.png")))
        ok &= good
        log("golden", scene=f"hw1_{mesh_name}", bad_frac=f"{bad:.5f}",
            mean=f"{mean:.4f}", ok=good)
    return ok


# --- phase 4: frame ---

def phase_frame(scene, card):
    from raytracinginonesemester_tpu.ops.backend import resolve_traversal
    from raytracinginonesemester_tpu.render.renderer import (
        DEFAULT_RAY_TILE, default_ray_tile)

    ok = True
    images = {}
    impls = {"xla": dataclasses.replace(scene, use_pallas=False)}
    if resolve_traversal(True) == "triton":
        impls["triton"] = dataclasses.replace(scene, use_pallas=True)
    for impl, s in impls.items():
        img = np.asarray(rt.render_scene(s, jitter_mode="wang"))
        ms = timed(lambda i: rt.render_scene(s, jitter_mode="wang",
                                             sample_offset=i))
        frames = rt.render_scene_frames(s, 4, jitter_mode="wang")
        ms_frames = timed(lambda i: rt.render_scene_frames(
            s, 4, jitter_mode="wang", sample_offset=4 * i), iters=3) / 4
        frames = np.asarray(frames)
        finite = bool(np.isfinite(img).all() and np.isfinite(frames).all())
        same0, bad0, _ = images_close(quantize(frames[0], "gpu"),
                                      quantize(img, "gpu"))
        images[impl] = img
        ok &= finite and same0 and img.shape == (H, W, 3)
        log("frame", impl=impl, ms_per_frame=f"{ms:.3f}",
            frames_ms_per_frame=f"{ms_frames:.3f}", finite=finite,
            frames0_vs_render_bad_frac=f"{bad0:.5f}",
            ray_tile=default_ray_tile(s), card=f"'{card}'")
    if "triton" in images:
        good, bad, mean = images_close(quantize(images["triton"], "gpu"),
                                       quantize(images["xla"], "gpu"))
        ok &= good
        log("frame", compare="triton_vs_xla", bad_frac=f"{bad:.5f}",
            mean=f"{mean:.4f}", ok=good)
    # the XLA block path's memory at the default tile and at whole frame
    xla = impls["xla"]
    for tile in (DEFAULT_RAY_TILE, 0):
        try:
            compiled = rt.render_scene.lower(
                xla, jitter_mode="wang", ray_tile=tile).compile()
            log("frame", xla_memory=f"ray_tile={tile or W * H}",
                mem=memory(compiled).replace(" ", ","))
        except Exception as e:  # a measurement, not a check
            log("frame", xla_memory=f"ray_tile={tile or W * H}",
                error=f"'{type(e).__name__}: {str(e)[:200]}'")
    return ok


# --- phase 5: train ---

def train_optimizer():
    """Adam with a learning rate per parameter's units: the triangle
    soup's vertices move in metres and crack the surface when steps are
    as large as the shading parameters'."""
    import optax

    return optax.multi_transform(
        {"shade": optax.adam(1e-2), "geom": optax.adam(1e-6)},
        lambda p: {k: "geom" if k == "vertices" else "shade" for k in p})

def phase_train():
    import optax

    from bench import grad_problem
    from raytracinginonesemester_tpu.diff.inverse import render_loss

    scene, params, target = grad_problem(960, 540)
    opt = train_optimizer()

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(lambda q: render_loss(
            q, scene, target, jitter_mode="center", spp_override=1))(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, grads

    state = opt.init(params)
    losses, grads_finite, times = [], True, []
    for _ in range(3):
        t0 = time.perf_counter()
        params, state, loss, grads = jax.block_until_ready(step(params,
                                                                state))
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        grads_finite &= all(bool(jnp.isfinite(g).all())
                            for g in jax.tree.leaves(grads))
    ok = (all(np.isfinite(losses)) and grads_finite
          and losses[-1] < losses[0])
    log("train", losses=",".join(f"{x:.6g}" for x in losses),
        grads_finite=grads_finite, step_ms=f"{min(times[1:]) * 1e3:.3f}",
        ok=ok)
    return ok


# --- four cards ---

def phase_multi(n):
    import optax

    from bench import grad_problem
    from raytracinginonesemester_tpu.diff.inverse import (apply_params,
                                                          render_loss)
    from raytracinginonesemester_tpu.parallel.sharded import (
        make_mesh, render_scene_sharded)

    ok = True
    scene = frog()
    # one tile shape for both renders: XLA compiles the shading glue per
    # shape, and only identical programs promise identical bits
    tile = 131072
    one = np.asarray(rt.render_scene(scene, jitter_mode="wang",
                                     ray_tile=tile))
    dp = make_mesh((n,), ("data",))
    img = np.asarray(render_scene_sharded(scene, dp, jitter_mode="wang",
                                          ray_tile=tile))
    same = bool(np.array_equal(img, one))
    ok &= same
    log("multi", render=f"dp={n}", bit_identical=same,
        max_abs=f"{float(np.max(np.abs(img - one))):.3g}")
    dptp = make_mesh((n // 2, 2), ("data", "model"))
    img = np.asarray(render_scene_sharded(scene, dptp, jitter_mode="wang",
                                          model_axis="model", ray_tile=tile))
    good, bad, mean = images_close(quantize(img, "gpu"), quantize(one, "gpu"))
    ok &= good
    log("multi", render=f"dpxtp={n // 2}x2", bad_frac=f"{bad:.5f}",
        mean=f"{mean:.4f}", ok=good)

    gscene, params, target = grad_problem(960, 540)
    loss_one = float(render_loss(params, gscene, target,
                                 jitter_mode="center", spp_override=1))
    opt = optax.adam(1e-2)

    @jax.jit
    def step(p, s):
        def loss_fn(q):
            img = render_scene_sharded(apply_params(gscene, q), dp,
                                       jitter_mode="center",
                                       spp_override=1)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, grads

    _, _, loss, grads = jax.block_until_ready(step(params, opt.init(params)))
    rel = abs(float(loss) - loss_one) / abs(loss_one)
    finite = all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(grads))
    good = finite and rel <= 1e-5
    ok &= good
    log("multi", train=f"dp={n}", loss=f"{float(loss):.8g}",
        loss_one_card=f"{loss_one:.8g}", rel=f"{rel:.2e}",
        grads_finite=finite, ok=good)
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: the one-card phases; 4: only the four-card "
                    "phase")
    args = ap.parse_args()

    enable_compile_cache()
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    if len(devices) < args.devices:
        print(f"chip_smoke: needs {args.devices} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    card = card_line()
    log("device", platform=dev.platform, kind=f"'{dev.device_kind}'",
        count=len(devices), jax=jax.__version__)
    print(card, flush=True)

    if args.devices > 1:
        phases = [("multi", lambda: phase_multi(args.devices))]
    else:
        scene = frog()
        phases = [("kernels", lambda: phase_kernels(scene)),
                  ("golden", phase_golden),
                  ("frame", lambda: phase_frame(scene, card)),
                  ("train", phase_train)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            good = fn()
        except Exception:
            traceback.print_exc()
            good = False
        log(name, done=good, seconds=f"{time.perf_counter() - t0:.1f}")
        if not good:
            failed.append(name)
    print(card, flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Timing, throughput metrics, and profiling utilities.

The analog of the reference's measurement discipline (SURVEY §5):
``std::chrono`` spans around renders with explicit device sync
(``main.cu:281-293, 361-378``; here ``jax.block_until_ready``), warmup
passes to exclude JIT cost (``warmup.h:10-90``), and rays/s derived
metrics — plus ``jax.profiler`` trace capture, which the reference has
no equivalent of.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Callable, Optional

import jax

__all__ = ["Timer", "measure", "profile_trace", "rays_per_second"]


class Timer:
    """Wall-clock span with device sync on exit.

    >>> with Timer("render") as t:
    ...     img = render_scene(scene)
    ...     t.result = img
    >>> t.seconds
    """

    def __init__(self, name: str = "", echo: bool = False):
        self.name = name
        self.echo = echo
        self.result = None
        self.seconds = 0.0

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if self.result is not None:
            jax.block_until_ready(self.result)
        self.seconds = time.time() - self.t0
        if self.echo:
            print(f"{self.name}: {self.seconds * 1e3:.2f} ms", file=sys.stderr)
        return False


def measure(fn: Callable, *args, warmup: int = 1, iters: int = 5) -> dict:
    """Warmup-then-measure (the reference's warmup discipline,
    ``warmup.h`` / ``main.cu:361-367``); returns timing stats in seconds."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.time()
        jax.block_until_ready(fn(*args))
        times.append(time.time() - t0)
    times.sort()
    return {
        "median_s": times[len(times) // 2],
        "min_s": times[0],
        "max_s": times[-1],
        "iters": iters,
    }


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/jax_trace"):
    """Capture a ``jax.profiler`` trace (view with TensorBoard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def rays_per_second(width: int, height: int, spp: int, seconds: float,
                    waves: int = 1) -> dict:
    """Derived throughput metrics: camera rays and traced-ray estimate."""
    camera_rays = width * height * spp
    return {
        "camera_rays_per_s": camera_rays / seconds,
        "traced_rays_per_s_est": camera_rays * waves / seconds,
        "frame_ms": seconds * 1e3,
    }

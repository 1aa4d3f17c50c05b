"""Progressive / resumable forward rendering.

The reference renders one-shot: the GPU driver loops over 32-sample
batches entirely in device registers (``query.cu:39-65``,
``antialias.h:39``) and nothing survives a crash but the final PNG.
SURVEY §5 calls out the batched framework's equivalent: per-pixel
accumulation buffers make forward-render resume trivial.  This module
is that equivalent — render ``spp`` in chunks of ``chunk`` samples,
keep the running radiance SUM on the host, and optionally persist
(accumulator, next_sample) after every chunk so an interrupted render
resumes where it stopped.

Sample seeds are absolute (``make_rng_seed(x, y, sample)``,
``query.h:44-48``) via ``sample_offset``, so the image is independent
of the chunking — and with ``chunk=1`` the host-side adds replay the
one-shot kernel's accumulation order exactly, making the progressive
result BIT-IDENTICAL to ``render_scene(scene)`` at the same spp.
Larger chunks change f32 association (chunk sums are computed before
the cross-chunk add) and match to ~1 ulp instead.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np

from .renderer import render_scene

__all__ = ["render_progressive", "save_render_state", "load_render_state"]

_STATE_FILE = "render_state.npz"


def save_render_state(directory: str, accum: np.ndarray,
                      next_sample: int) -> str:
    """Persist the progressive accumulator; returns the file path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _STATE_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # atomic publish: write-then-rename
        np.savez(f, accum=accum, next_sample=np.int64(next_sample))
    os.replace(tmp, path)
    return path


def load_render_state(directory: str) -> Optional[Tuple[np.ndarray, int]]:
    """Load (accum, next_sample), or None if no state exists."""
    path = os.path.join(directory, _STATE_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return z["accum"].copy(), int(z["next_sample"])


def render_progressive(
    scene,
    spp: Optional[int] = None,
    chunk: int = 1,
    jitter_mode: str = "auto",
    ray_tile: Optional[int] = None,
    state_dir: Optional[str] = None,
    on_chunk: Optional[Callable[[int, np.ndarray], None]] = None,
) -> np.ndarray:
    """Render ``spp`` samples (default ``scene.spp``) in ``chunk``-sample
    dispatches; returns the normalized (H, W, 3) float32 image.

    ``state_dir`` enables resume: the accumulator is persisted after
    every chunk, and a fresh call with the same ``state_dir`` continues
    from the last completed chunk.  ``on_chunk(done_spp, preview)`` is
    called after each chunk with the current normalized preview.
    """
    total = int(scene.spp if spp is None else spp)
    if total <= 0:
        raise ValueError(f"spp must be positive, got {total}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")

    accum, start = None, 0
    if state_dir is not None:
        state = load_render_state(state_dir)
        if state is not None:
            accum, start = state
            if start >= total:  # already complete at this spp
                return accum / np.float32(total)

    s = start
    while s < total:
        c = min(chunk, total - s)
        part = np.asarray(
            render_scene(scene, jitter_mode=jitter_mode, ray_tile=ray_tile,
                         spp_override=c, sample_offset=s, normalize=False),
            dtype=np.float32,
        )
        accum = part if accum is None else accum + part
        s += c
        if state_dir is not None:
            save_render_state(state_dir, accum, s)
        if on_chunk is not None:
            on_chunk(s, accum / np.float32(s))
    return accum / np.float32(total)

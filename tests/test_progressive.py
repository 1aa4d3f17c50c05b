"""Progressive / resumable rendering (render.progressive).

The forward-render resume story from SURVEY §5: spp rendered in chunks
with a persisted host-side accumulator.  chunk=1 must be BIT-IDENTICAL
to the one-shot render (the host adds replay the kernel's accumulation
order); larger chunks reassociate the f32 sums and only match closely.
"""

import dataclasses

import numpy as np

from raytracinginonesemester_tpu.render.progressive import (
    load_render_state,
    render_progressive,
    save_render_state,
)
from raytracinginonesemester_tpu.render.renderer import render_scene

from conftest import two_frog_scene as _two_frog_scene


def test_progressive_chunk1_bit_identical():
    scene = _two_frog_scene(width=48, height=32, spp=4, diffuse_bounce=True,
                            max_bounces=2)
    one_shot = np.asarray(render_scene(scene))
    prog = render_progressive(scene, chunk=1)
    np.testing.assert_array_equal(one_shot, prog)


def test_progressive_chunk2_close():
    scene = _two_frog_scene(width=48, height=32, spp=4, diffuse_bounce=True,
                            max_bounces=2)
    one_shot = np.asarray(render_scene(scene))
    prog = render_progressive(scene, chunk=2)
    np.testing.assert_allclose(one_shot, prog, rtol=0.0, atol=2e-6)


def test_progressive_resume(tmp_path):
    scene = _two_frog_scene(width=48, height=32, spp=4, diffuse_bounce=True,
                            max_bounces=2)
    state = str(tmp_path / "state")

    # simulate an interruption after 2 of 4 samples
    calls = []

    class Stop(Exception):
        pass

    def interrupt(done, _preview):
        calls.append(done)
        if done == 2:
            raise Stop

    try:
        render_progressive(scene, chunk=1, state_dir=state,
                           on_chunk=interrupt)
    except Stop:
        pass
    accum, nxt = load_render_state(state)
    assert nxt == 2 and calls == [1, 2]

    # resume completes the remaining samples; result is bit-identical
    # to the uninterrupted one-shot render
    resumed = render_progressive(scene, chunk=1, state_dir=state)
    one_shot = np.asarray(render_scene(scene))
    np.testing.assert_array_equal(one_shot, resumed)

    # calling again when complete just returns the finished image
    again = render_progressive(scene, chunk=1, state_dir=state)
    np.testing.assert_array_equal(resumed, again)


def test_state_roundtrip(tmp_path):
    acc = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    save_render_state(str(tmp_path), acc, 7)
    loaded, nxt = load_render_state(str(tmp_path))
    assert nxt == 7
    np.testing.assert_array_equal(acc, loaded)
    assert load_render_state(str(tmp_path / "nope")) is None

"""The one rule that picks a traversal implementation for the platform.

Every caller that traces rays through a block grid asks
``resolve_traversal`` which implementation to run:

- ``"triton"``: the Pallas-through-Triton kernels (``ops.pallas_kernels``),
  compiled for the GPU;
- ``"xla"``: the XLA block path (``ops.accel.block_closest`` /
  ``block_occluded``);
- ``"interpret"``: the Triton kernels run by the Pallas interpreter.  Only
  an explicit request gives it (tests on the CPU); it is never a fallback.
"""

from __future__ import annotations

import jax

__all__ = ["GPU_TRAVERSAL", "resolve_traversal"]

# What ``use_pallas=None`` means on a GPU: the implementation that won
# frog 1080p depth-8 end to end on the H100 (PERF.md).
GPU_TRAVERSAL = "triton"

_PLATFORMS = ("gpu", "cpu")


def resolve_traversal(use_pallas=None, interpret: bool = False,
                      platform: str | None = None) -> str:
    """Traversal implementation for ``platform`` (default: JAX's).

    ``use_pallas``: None picks the platform's default (``GPU_TRAVERSAL``
    on a GPU, the XLA block path on the CPU); True asks for the Triton
    kernels, which need a GPU unless ``interpret`` is set; False asks for
    the XLA block path.
    """
    platform = platform or jax.default_backend()
    if platform not in _PLATFORMS:
        raise ValueError(
            f"no traversal implementation for platform {platform!r}; "
            f"supported: {', '.join(_PLATFORMS)}")
    if interpret:
        if use_pallas is False:
            raise ValueError(
                "interpret=True runs the Pallas kernels, but "
                "use_pallas=False asks for the XLA block path")
        return "interpret"
    if use_pallas is None:
        return GPU_TRAVERSAL if platform == "gpu" else "xla"
    if use_pallas:
        if platform != "gpu":
            raise ValueError(
                f"use_pallas=True needs a GPU, but the platform is "
                f"{platform!r}; set interpret=True to run the kernels in "
                "the Pallas interpreter")
        return "triton"
    return "xla"

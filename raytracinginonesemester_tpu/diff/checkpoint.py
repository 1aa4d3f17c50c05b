"""Checkpoint/resume for inverse-rendering optimization.

The reference has no checkpointing (renders are one-shot; SURVEY §5) —
this is the framework's standard-issue equivalent for its new
differentiable-optimization loop: orbax when available, with a
pickle fallback, saving (params, opt_state, step, losses).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional, Tuple

import jax
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]


def _to_host(tree):
    return jax.tree.map(lambda a: np.asarray(a) if hasattr(a, "shape") else a, tree)


def save_checkpoint(directory: str, step: int, params, opt_state=None,
                    losses=None) -> str:
    """Write a checkpoint; returns its path."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "step": int(step),
        "params": _to_host(params),
        "opt_state": _to_host(opt_state),
        "losses": list(losses) if losses is not None else None,
    }
    try:
        import orbax.checkpoint as ocp

        path = os.path.join(directory, f"ocp_{step:08d}")
        with ocp.StandardCheckpointer() as ckptr:
            ckptr.save(os.path.abspath(path), payload["params"])
        # orbax stores params; sidecar pickle keeps step/opt/losses
        with open(os.path.join(directory, f"meta_{step:08d}.pkl"), "wb") as f:
            pickle.dump({k: v for k, v in payload.items() if k != "params"}, f)
        return path
    except Exception:
        path = os.path.join(directory, f"ckpt_{step:08d}.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        for prefix in ("ckpt_", "ocp_", "meta_"):
            if name.startswith(prefix):
                digits = name[len(prefix):].split(".")[0]
                if digits.isdigit():
                    steps.append(int(digits))
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None) -> Tuple[int, Any, Any, Any]:
    """Load (step, params, opt_state, losses); newest checkpoint if
    ``step`` is None."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")

    pkl = os.path.join(directory, f"ckpt_{step:08d}.pkl")
    if os.path.exists(pkl):
        with open(pkl, "rb") as f:
            payload = pickle.load(f)
        return payload["step"], payload["params"], payload["opt_state"], payload["losses"]

    import orbax.checkpoint as ocp

    path = os.path.join(directory, f"ocp_{step:08d}")
    with ocp.StandardCheckpointer() as ckptr:
        params = ckptr.restore(os.path.abspath(path))
    with open(os.path.join(directory, f"meta_{step:08d}.pkl"), "rb") as f:
        meta = pickle.load(f)
    return meta["step"], params, meta["opt_state"], meta["losses"]

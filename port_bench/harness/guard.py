"""The check that a run loaded nothing of JAX or of the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "quadruped_tpu")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among loaded modules, each module
    name compared whole up to its first dot (quadruped_tpu_torch passes)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))

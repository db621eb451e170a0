"""The run's guard against the JAX package: no module whose top-level name
(the part before the first dot, compared whole) is one of ``BANNED`` may be
loaded in the process that prints the result."""
from __future__ import annotations

import sys

BANNED = ("jax", "jaxlib", "flax", "orbax", "unified_audio_tpu")


def banned_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted(n for n in list(names) if n.split(".")[0] in BANNED)

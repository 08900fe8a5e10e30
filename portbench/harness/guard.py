"""The run's own look for JAX: what the port loaded in this process."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "hypergen_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's, Flax's or the JAX package's:
    ``hypergen_tpu.x`` is one, ``hypergen_tpu_torch.x`` is not."""
    names = sys.modules.keys() if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)

"""The import guard: no run may load JAX or the JAX package.

Modules are compared by their whole top-level name (the part before the
first dot), so ``lra_tpu_torch`` (the port, whose name begins with the
JAX package's) passes and ``lra_tpu`` or ``lra_tpu.ops`` does not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lra_tpu"})


def loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)

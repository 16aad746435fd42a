"""The import guard: the benchmark runs without JAX and without the JAX
package, whose name ``ceph_tpu`` begins ``ceph_tpu_torch``'s, so names
are compared whole, on the part before the first dot."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ceph_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check() -> None:
    """Raise naming every forbidden module that is loaded."""
    found = forbidden_modules()
    if found:
        raise ImportError(f"forbidden modules loaded: {', '.join(found)}")

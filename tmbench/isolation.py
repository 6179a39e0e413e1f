"""What the benchmark's process may not load: JAX, its libraries and the
reference package ``repro`` that the port was made from.  Module names
are compared by their top-level name (before the first dot) whole, so
``repro_torch`` is the program and ``repro`` is not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(names) -> list:
    """The names among ``names`` whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def forbidden_modules() -> list:
    return forbidden(list(sys.modules))

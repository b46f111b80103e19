"""The import guard: no loaded module may be JAX's or the JAX package's.
Names are compared by their top-level part (before the first dot) as a
whole word, since the port's own name begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "medfusion_tpu"})


def forbidden(modules: Iterable[str]) -> List[str]:
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def check() -> None:
    """Exit with code 4, naming what was found on stderr, where
    ``sys.modules`` holds a forbidden module."""
    found = forbidden(list(sys.modules))
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr, flush=True)
        raise SystemExit(4)

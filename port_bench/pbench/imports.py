"""The check that a run loaded neither JAX nor the JAX package.

A module counts by its top-level name, the part before the first dot,
compared whole: ``skyplane_tpu_torch`` (the port) begins with
``skyplane_tpu`` (the JAX package) and is not it.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "skyplane_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)

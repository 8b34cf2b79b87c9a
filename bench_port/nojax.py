"""The check that the process ran without JAX: no module whose top-level
name (the part before the first dot), compared whole, is JAX's, jaxlib's,
flax's or the JAX package's.  The port's package name begins with the JAX
package's, so prefixes are not compared."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "multimodalautoencoder_tpu"))


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the
    process's loaded modules), sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)

"""The modules a run may not load: JAX and the JAX package this repository
ported. Compared by whole top-level names (the part before the first dot),
since the port's own name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "unidepth_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))

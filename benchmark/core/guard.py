"""What a run may not load: JAX, its libraries, and the JAX package that
the port was made from.  Names are compared whole, by the part before the
first dot: ``climatemodel_tpu_torch`` is the port, not the JAX package."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'climatemodel_tpu'})


def forbidden_loaded(modules=None):
    """Sorted top-level names in ``modules`` (default ``sys.modules``) that
    a run may not load."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.', 1)[0] for m in names} & FORBIDDEN)

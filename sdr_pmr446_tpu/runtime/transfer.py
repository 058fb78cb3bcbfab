"""Device->host fetch of output and state pytrees."""

from __future__ import annotations

import jax


def fetch(tree):
    """Device pytree -> host (NumPy) pytree, dtype-preserving.  All leaves'
    copies are started before any is waited on (``jax.device_get``)."""
    return jax.device_get(tree)

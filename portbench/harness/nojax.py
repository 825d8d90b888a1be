"""The check that a run loaded nothing of JAX or of the JAX package."""

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "mpc_mmd_tpu")


def loaded() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``mpc_mmd_tpu_torch`` is not
    ``mpc_mmd_tpu``."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)

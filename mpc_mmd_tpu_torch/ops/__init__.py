"""Hand-written CUDA kernels of the main path and their wrappers.

K1 ``topk_indices``, K2 ``eq_qp_solve`` and K4 ``fused_rollout``.  Each
wrapper takes its plain twin for CPU tensors and launches its kernel for
CUDA tensors, counting launches in ``<wrapper>.launches``.
"""

from .qp import eq_qp_solve
from .rollout import fused_rollout
from .topk import topk_indices

KERNELS = (topk_indices, eq_qp_solve, fused_rollout)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["eq_qp_solve", "fused_rollout", "topk_indices", "KERNELS",
           "reset_launch_counts"]

"""Hand-written CUDA kernels of the port and their wrappers.

K1 ``topk_indices``, K2 ``eq_qp_solve``, K3 ``topk_kernel_matrices``, K4
``fused_rollout`` and K5 ``topk_onehot``.  Each wrapper takes its plain twin
for CPU tensors and launches its kernel for CUDA tensors, counting launches
in ``<wrapper>.launches``.
"""

from .qp import eq_qp_solve
from .rollout import fused_rollout
from .topk import topk_indices, topk_onehot
from .topk_kernel import topk_kernel_matrices

KERNELS = (topk_indices, eq_qp_solve, topk_kernel_matrices, fused_rollout,
           topk_onehot)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["eq_qp_solve", "fused_rollout", "topk_indices", "topk_onehot",
           "topk_kernel_matrices", "KERNELS", "reset_launch_counts"]

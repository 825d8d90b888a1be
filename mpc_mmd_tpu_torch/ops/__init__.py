"""Hand-written CUDA kernels of the port and their wrappers.

K1 ``topk_indices``, K2 ``eq_qp_solve`` (and its lane-major entry
``eq_qp_solve_t``), K3 ``topk_kernel_matrices``, K4 ``fused_rollout`` and
K5 ``topk_onehot``; and the JAX key chain's draws, ``prng_draws`` (keys to
bits, uniforms or normals) and ``prng_beta`` (Beta draws).  Each wrapper
takes its plain twin for CPU tensors and launches its kernel for CUDA
tensors, counting launches in ``<wrapper>.launches``.
"""

from .prng import prng_beta, prng_draws
from .qp import eq_qp_solve, eq_qp_solve_t
from .rollout import fused_rollout
from .topk import topk_indices, topk_onehot
from .topk_kernel import topk_kernel_matrices

KERNELS = (topk_indices, eq_qp_solve, topk_kernel_matrices, fused_rollout,
           topk_onehot, eq_qp_solve_t, prng_draws, prng_beta)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["eq_qp_solve", "eq_qp_solve_t", "fused_rollout", "prng_beta",
           "prng_draws", "topk_indices", "topk_onehot", "topk_kernel_matrices",
           "KERNELS", "reset_launch_counts"]

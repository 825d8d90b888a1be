"""Hand-written CUDA kernels of the port and their wrappers.

K1 ``topk_indices``, K2 ``eq_qp_solve`` (and its lane-major entry
``eq_qp_solve_t``), K3 ``topk_kernel_matrices``, K4 ``fused_rollout`` and
K5 ``topk_onehot``; the JAX key chain's draws, ``prng_draws`` (keys to
bits, uniforms or normals), its plan form ``prng_plan`` (every Gaussian
draw of a solve in one launch) and ``prng_beta`` (Beta draws); kernel (c)
``inner_cem``, the whole inner beta-CEM under every selection (and the
launch counts of its forms, ``inner_cem_fused``, ``inner_cem_xt`` and
``inner_cem_g``); the outer
iteration's kernel (d) ``outer_project`` (guess QP, projection, controls)
and kernel (e) ``outer_tail`` (risk, cost and CEM update in ``mmd_opt``);
and the glue around the rollouts: K4n ``noisy_rollout`` (K4's entry that
forms the noisy controls as it loads them), kernel (f) ``inner_prologue``
(the refit and distance matrices before the inner CEM) and kernel (g)
``frenet_points`` (the on-road rollouts' Frenet coordinates), with its
state form ``frenet_states`` (the on-road solve's noisy initial states and
boundary rows) and obstacle form ``frenet_obstacles`` (with the
obstacles' constant-velocity trajectories); and the closed loop's kernel
(h) ``local_frame`` (the path smoother's rounds and the path parameters of
a step's local path).  Each wrapper
takes its plain twin for CPU tensors and launches its kernel for CUDA
tensors, counting launches in ``<wrapper>.launches`` (the forms' counts
beside them in ``KERNELS``).

A CUDA graph (``graph.py``) replays kernels without calling their
wrappers: it reads the counts its capture added (:func:`launch_counts`
before and after), takes them back (:func:`set_launch_counts`, since a
capture runs nothing) and adds them again at every replay
(:func:`add_launches`).
"""

from typing import Dict

from .frenet_points import frenet_obstacles, frenet_points, frenet_states
from .inner_cem import inner_cem, inner_cem_fused, inner_cem_g, inner_cem_xt
from .inner_prologue import inner_prologue
from .local_frame import local_frame
from .outer_project import outer_project
from .outer_tail import outer_tail
from .prng import prng_beta, prng_draws, prng_plan
from .qp import eq_qp_solve, eq_qp_solve_t
from .rollout import fused_rollout, noisy_rollout
from .topk import topk_indices, topk_onehot
from .topk_kernel import topk_kernel_matrices

KERNELS = (topk_indices, eq_qp_solve, topk_kernel_matrices, fused_rollout,
           topk_onehot, eq_qp_solve_t, prng_draws, prng_beta, inner_cem, outer_project,
           outer_tail, noisy_rollout, inner_prologue, frenet_points, inner_cem_fused,
           inner_cem_xt, inner_cem_g, frenet_states, frenet_obstacles, local_frame,
           prng_plan)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """Every wrapper's launch count, by the wrapper's name."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def set_launch_counts(counts: Dict[str, int]) -> None:
    for fn in KERNELS:
        fn.launches = counts[fn.__name__]


def add_launches(counts: Dict[str, int]) -> None:
    """Adds ``counts`` (by wrapper name) to the wrappers' counts."""
    for fn in KERNELS:
        fn.launches += counts.get(fn.__name__, 0)


__all__ = ["eq_qp_solve", "eq_qp_solve_t", "frenet_obstacles", "frenet_points",
           "frenet_states", "fused_rollout", "inner_cem",
           "inner_cem_fused", "inner_cem_g", "inner_cem_xt", "inner_prologue", "local_frame",
           "noisy_rollout", "outer_project", "outer_tail", "prng_beta", "prng_draws",
           "prng_plan",
           "topk_indices", "topk_onehot", "topk_kernel_matrices", "KERNELS",
           "add_launches", "launch_counts", "reset_launch_counts", "set_launch_counts"]

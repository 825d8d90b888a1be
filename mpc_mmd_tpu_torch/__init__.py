"""PyTorch port of the risk-aware MPC-MMD engine, for an NVIDIA H100.

Beside the JAX package ``mpc_mmd_tpu``, which stays the reference; module
names mirror it.  This package imports torch and never jax.

TF32 is switched off for matmuls and cuDNN on import.  TF32 keeps about
three decimal digits, and the solve relies on values passing through
unchanged: the inner CEM carries its elite rows and their selection results
across iterations, and candidate order is decided by sorts of risks that
differ in the fourth digit.  Every matmul of the port is full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import (ProblemConfig, dynamic_workload,  # noqa: E402
                     fast_workload, fastrt_workload, onroad_workload,
                     realtime_workload, static_workload)
from .solver import SolveResult, Solver  # noqa: E402
from .solver_frenet import FrenetSolveResult, FrenetSolver  # noqa: E402
from .closedloop import run_episode  # noqa: E402

__all__ = ["FrenetSolveResult", "FrenetSolver", "ProblemConfig", "Solver",
           "SolveResult", "dynamic_workload", "fast_workload",
           "fastrt_workload", "onroad_workload", "realtime_workload",
           "run_episode", "static_workload"]
